#!/usr/bin/env python3
"""Drive sleepgen_torch on one CUDA card and check it end to end.

Run from the repo root on a machine with an NVIDIA Hopper card and the
CUDA toolkit: ``python3 chip_smoke.py``. It drives eleven paths: LDM
sampling, stage-2 LDM training, stage-1 AEKL training, the evaluation
(DPM++2M sampling, ``compute-fid``, ``compute-mmds``), serving
(``SamplerService``, ``serve``, ``warm-cache``; stage-conditional and
guided sampling), the signal-space DM (``sample-dm``, ``train-dm``,
``impute`` in signal and latent space), downstream sleep-stage decoding
(EDF files, ``convert-edfx``, ``decode``), the evaluation tail
(``sample-ae``, ``band-eval``), the first-generation pipeline (the v1 VAE
against the v1 PatchGAN, DDPM-v1 training, ancestral sampling), int8
quantized sampling, the long window, the models' options and data
parallelism over ``torch.distributed``. Phases, one line each:

  1. device: the card's name and power limit (nvidia-smi); then whether
     matplotlib and pandas can be imported here (the port needs neither);
  2. build: compile the kernels from sleepgen_torch/csrc, one nvcc per
     source, in parallel;
  3. kernel checks: one-step runs of the paths record the shapes they
     give each kernel (a DDIM step of the sampler at batch 64; one
     full-width training step at batch 1024, whose launch counts must
     equal those derived from the configuration, K2 none; then a warm-up
     eval batch, one more step and two eval batches on the fp32 masters:
     the first after the step re-lays out each K2 weight once, the second
     none; one full-width stage-1 step at ``aekl_eeg.yaml``'s batch 2048,
     bf16, whose K1 and K3 launches, 26 each, must equal those derived
     from the configuration, K2 none, and must all take the cluster form
     (``read_forms()``), with the strided dy copies K3's wrapper made; one ``compute-mmds`` reconstruction batch of 64
     windows, fp32, whose 26 K1 launches must equal those derived from the
     configuration and take the cluster form; one DDIM step of the full-width DM (``dm.yaml``) at
     batch 64 through ``sample_dm_trials``, and one full-width DM training
     step at ``dm.yaml``'s batch 512, bf16, each with its launch counts
     equal to those derived from the configuration (the step: K1 and K3
     49 each, K2 none; its groups of exactly 12,288 elements run K1 and K3
     on chip, those of 18,432-36,864 in K1's and K3's cluster form at
     G 32)); one full-width step of each v1 path at
     the trainers' batch 16, fp32 (an encoder step: K1 and K3 at each of
     the VAE's 36 GroupNorms, G 32, groups of 3,072-12,288 elements, on
     chip; a DDPM step: K1 53, K3 35; an ancestral step: K1 9 and K2 26
     on K2's fp32 path at C_out 64 and 128; the decode: K1 18); one DDIM
     step of the long window (``benches/long_window.py``: the default
     UNet on windows of 12288 at batch 16, bf16, block 512: K1 at
     49,152-element groups at G 32, in the cluster form, K2 at L 12288) and one of the flagship
     int8 sampler at batch 64 (K1 at each of the UNet's 49 GroupNorms and
     the decoder's 13, no K2), each with its counts as derived; at every one of
     them, each kernel is held to its plain PyTorch version, in fp32 (TF32
     off; K1 rtol 1e-5 / atol 2e-6, K2 2e-4, K3 rtol 1e-4 / atol 1e-5,
     the bounds of tests/test_pallas_kernels.py, with K3's dscale and dbias
     atol scaled by sqrt(B L), as fp32 rounding of a B L-term sum grows
     with its square root) and in bf16 (against the plain version in fp32
     on the same bf16 inputs, to bf16 rounding: K1 and K3's dx |err| <=
     2^-8 |ref| + 1e-5, K2 |err| <= 2^-8 |ref| + 2^-6 rms(ref), as K2
     also rounds h to bf16 before its convolution; K3's dscale and dbias
     are fp32 sums, held to the fp32 bound). B2 is checked at its long
     window (16, 32, 49152, G 1) and B3 at the Pallas test shapes and one
     sampler shape;
  4. tiny sampler: 4 DDIM steps plus decode at tiny widths, on the card
     with the kernels against the CPU with the plain versions, same seeds
     and weights, fp32, at the model parity bound (rtol 2e-3 / atol 2e-4);
  E1. tiny evaluation, card against CPU, same seeds and weights, fp32 with
     TF32 off: 4 DPM++2M steps plus decode at tiny widths (model bound,
     launch counts as derived); USleep (depth 12, L 3000, two sets of 8
     windows, random BatchNorm statistics) bottleneck features at the
     model bound and the Fréchet distance of the two sets within rtol
     1e-3; ``ms_ssim_1d`` with the gaussian k 7 and the uniform k 16
     kernels, and ``filter_band`` for each band, within rtol 1e-4 / atol
     1e-5;
  S1. tiny serving: ``SamplerService`` over port run dirs of a tiny
     conditional checkpoint (UNet mc 32, [1, 2], attention [2], G 8, 5
     classes, latent 64; AEKL [2, 2, 4]; fp32, TF32 off; seeded weights),
     on the card against the same service on the CPU: DPM++2M-4 at batch
     4, stage 2 plain and guided at 2.0, at the model bound (rtol 2e-3 /
     atol 2e-4); the guided request's launches equal the plain one's, as
     derived from the configuration; the sampler cache holds (4, False)
     and (4, True) after scales 2.0 and 3.0; each invalid request (no
     stage, stage -1, stage 5, a guidance scale that is not a number)
     raises with no kernel launched;
  5. full width: ``sample_ldm_trials`` at the flagship configuration
     (UNet mc 128 / [1, 2, 4] / attention [8, 4] / G 32 / latent 768 x 1,
     AEKL [32, 32, 64], bf16), batch 64, 200 DDIM steps, seeded random
     weights, called once per batch for three batches after the warm-up;
     each batch's launch counts must equal those derived from the
     configuration; prints each batch's seconds and the median windows/s;
     then one batch in a fresh process (``--cold-batch``), the first batch
     a user of the entry point pays for (kernels already on disk);
  6. tiny trainer: two Adam steps at tiny widths, fp32, on the card and on
     the CPU from the same weights, batch, t, noise and encoder eps, loss
     and parameters at the model bound; then one ``train_ldm`` run on the
     card that reaches an eval, the in-training DDPM sample and a
     checkpoint;
  7. full-width trainer: ``train_ldm`` on a synthetic npy tree at
     ldm.yaml's width, batch 1024, bf16, seven one-step epochs: median ms
     per step after the first (min-max), windows/s, peak memory; launch
     counts equal those derived from the configuration; finite losses;
  S1. tiny stage-1 trainer: two steps (the G step, then the D step) at
     tiny widths, fp32, Adam at 1e-4 for G and D, on the card and on the
     CPU from the same weights, batch and eps: losses at the model bound,
     each step's gradients within 2e-3 of each leaf's largest, and what
     the steps changed in the parameters and BatchNorm statistics within
     1e-2 of each leaf's largest change (parameter entries whose gradient
     is below 1e-3 of their leaf's largest left out, as Adam's update
     takes their sign from a rounding); then one ``train_aekl`` run
     on the card that reaches an eval, a checkpoint and
     ``best_model/params.npz``, and one ``train_ldm`` run on that run dir
     (the port's stage 1 into its own stage 2);
  S2. full-width stage-1 trainer: ``train_aekl`` at ``aekl_eeg.yaml``
     (AEKL [32, 32, 64], PatchDiscriminator 3 x 64, batch 2048, bf16) on a
     synthetic npy tree, seven one-step epochs and one eval after the
     last: median ms per step after the first (min-max), windows/s, peak
     memory; K1 and K3 launches equal those derived from the
     configuration; finite losses;
  E2. full-width evaluation on a synthetic test split of 1024 recordings
     of 35 s: ``sample_ldm_trials`` at the flagship configuration with
     DPM++2M-20, batch 64, seeded weights: a warm-up batch, three timed
     batches (median windows/s, min-max; K1 and K2 launches per batch as
     derived from the configuration), then seeds 0-1023 in 16 batches as
     artifacts; ``python -m sleepgen_torch compute-fid`` (USleep depth 12,
     seeded weights) on those samples against the split, then the
     test-vs-test floor, each finite and at least -1e-6, with the CLI's
     seconds and the features/s of ``usleep_fid_features``;
     ``compute-mmds`` in both modes on a seeded full-width AEKL run dir
     (``save_params_npz``): 26 K1 launches per reconstruction batch, one
     TSV row per window (per pair), every score finite, and windows/s;
  S2. full-width serving: ``SamplerService`` at the flagship
     configuration made a conditional checkpoint of the 5 sleep stages,
     DPM++2M-20, bf16, batch 64, seeded weights: ``warmup()``'s seconds;
     three rounds of a plain request of 64 seeds (stage 2), a guided one
     (stage 2, scale 2.0) and one of seed 5 alone, each with K1 and K2
     launches as derived from the configuration (233 and 760: a guided
     request runs one forward of 128 per step), no K2 weight re-layout,
     and the seconds ``sample_async`` took to return against
     ``result()``'s; seed 5 alone against seed 5 in the batch within 2^-6
     of the batch's largest |value|; ``sample_async`` of a plain and a
     guided request under torch's sync debug mode "error" (no PyTorch
     call in it waits for the card), and of a one-step request queued
     behind 1.5 s of a spin kernel, which must return while the card
     still spins (the 20-step requests are timed the same way: their
     launches overflow the card's queue of pending launches);
     one plain and one guided request under torch.profiler; the guided
     request's K1 and K2
     shapes (batch 128) are then checked in fp32 and bf16 like phase 3's;
  S3. the serving CLIs, each in a process of its own, on port run dirs of
     S2's configuration: ``warm-cache --targets sampler,dpm --batch_sizes
     64`` (seconds), then ``serve`` fed four requests of 64 seeds with a
     stage each and one without, strict and with ``--pipeline``: the
     error line, the two modes' artifacts equal, the ready line's warm-up
     seconds and each mode's windows/s from the first request sent to the
     last response;
  M1. tiny DM, card against CPU, same seeds and weights, fp32 with TF32
     off: ``sample_dm_trials`` with 4 DDIM steps at UNet mc 32, [1, 2],
     attention [2], G 8 on windows of 4096 (groups of 16,384-49,152
     elements: K1's and K3's cluster form at G 8), at the model bound, launch
     counts as derived; two DM training steps, and one conditional step
     (5 classes, two labels dropped to the null label, the spectral term
     on), each held by ``hold_tiny_stage1`` (metrics, each step's
     gradients, what the steps changed); RePaint over an 8-step schedule
     with ``num_resample`` 2 on the same injected noise, in signal space
     (``impute_dm``) and in latent space (``impute_ldm``, the tiny LDM and
     AEKL [4, 4, 8]), at the model bound, the observed region equal to
     x_known bitwise on the card, launch counts as derived;
  M2. full-width DM (``dm.yaml``, bf16, seeded weights in port run dirs):
     ``python -m sleepgen_torch sample-dm`` (64 seeds, DDIM-200 over the
     1000-entry table, artifacts; the warm-up), then three timed batches of
     64 through ``sample_dm_trials`` with their launch counts (median
     windows/s, min-max); ``train-dm`` on a synthetic npy tree of 512 + 64
     recordings, seven one-step epochs at batch 512 (median ms per step
     after the first, windows/s, peak memory, K1 and K3 launches as
     derived); ``impute`` in signal mode (16 windows, one batch, 1000
     RePaint steps) and in latent mode over the flagship LDM and AEKL:
     seconds per batch, windows/s, launch counts, observed samples
     unchanged; ``warm-cache --targets ldm`` on S2's conditional config
     (one labelled training step at batch 1024) in a process of its own;
  D1. decoders, card against CPU: the decode CLI's three decoders (a: the
     3-window Chambon stager, b: the single-window one, c: DeepSleepNet)
     at their published widths, batch 8, fp32 with TF32 off, dropout 0,
     from the same weights (random BatchNorm statistics): a forward in
     eval mode at the model bound, then two training steps (AdamW at 1e-4
     on the cosine schedule) held by ``hold_decoder_run``: losses, each
     step's gradients within 2e-3 of each leaf's largest, the BatchNorm
     running statistics within 1e-5 (the means after the second step
     also 0.2 lr: the noise-driven biases before them);
  D2. the decode path at a realistic size: 40 synthetic staged nights of
     1,000 scored 30 s epochs (``make_synthetic_staged``; 40 x 3.0 M
     samples) written as PSG and hypnogram EDFs (``write_edf``),
     ``convert-edfx`` (seconds per recording), then ``decode`` in each
     variant for 2 epochs at the CLI's batch 64: training steps/s and
     windows/s, seconds per epoch with both prediction passes, prediction
     windows/s, peak memory, the card's busy share over 20 profiled steps
     of the trainer's loop (gather, copy, step), the final balanced
     accuracy (in [0, 1]) and the confusion matrix's sum (the valid set's
     size);
  D3. the evaluation tail on E2's test split: ``sample-ae`` on
     aekl_eeg.yaml's AEKL (seeded weights) at batch 64, 26 K1 launches a
     batch, reconstruction windows/s; K1 held to its plain version at
     ``band-eval``'s batch-512 reconstruction shapes (fp32 and bf16),
     their 26 launches all in the cluster form, then ``band-eval`` in
     each of its four modes with MS-SSIM (26 K1 launches in the
     reconstruction mode) and once with both metrics (FID
     on seeded USleep weights), each's seconds; where matplotlib is
     present, the figures ``sample-ae`` and the tiny ``train_aekl`` run
     wrote, else ``sample-ae --no_figures``;
  V1. tiny v1 pipeline, card against CPU, same seeded weights and draws,
     fp32 with TF32 off (VAE n_channels 8, ch_mult (1, 2), G 4; PatchGAN
     ndf 8, 2 layers; UNet mc 16, [1, 2], attention [2], G 4; L 256): two
     encoder steps (the trainers' clipped Adams) and one DDPM step, each
     held by ``hold_tiny_stage1`` with the v1 metrics (the VAE's leaves
     in the JAX layout, its q, k and v fused); ``p_sample_loop`` over a
     4-entry table plus the decode at the model bound; launch counts as
     derived;
  V2. the v1 pipeline through its trainers at their default widths on
     3072-sample windows, batch 16, fp32: ``train_v1_encoder`` for five
     one-step epochs with one validation (best L1, run dir, peak memory),
     ``train_v1_ddpm`` over its final_model for five one-step epochs, one
     ``p_sample_loop`` of 1000 steps and ``reconstruct_ldm_outputs``
     (seconds, windows/s, ms per step), each call's launches as derived,
     the chain's K2 weight re-layouts one per K2 weight (26), not one per
     launch; then the encoder, DDPM and ancestral steps each on the host clock
     (median of five) and under torch.profiler (device ms, busy share);
  Q1. int8 sampling: tiny, every int8 layer of one UNet forward on the
     card against the same layer on the CPU on the card's input (int8
     activations and int32 accumulators equal, outputs at fp32 rounding;
     whole int8 outputs are not held across devices, as a rounding's
     difference flips an int8 value and the chain of int8 layers carries
     it on), and ``sample_ldm_trials(quantized=True)`` at DDIM-4 with its
     launches; then the flagship configuration at batch 64, DDIM-200: an
     int8 warm-up batch, then bf16, int8, int8, bf16 batches on the same
     seeds (seconds, median windows/s, K1 at every GroupNorm and no K2 for
     int8, the int8 signals' relative L2 to the bf16 ones), and one int8
     DDIM step profiled (host ms, device ms by kernel, busy share);
  W1. the long window: a ``kv_block_size`` of 1000 (not a divisor of the
     3072 attention tokens) refused with JAX's AssertionError and nothing
     launched; blocks 512 and 0 at DDIM-50, batch 16, bf16 (seconds, ms
     per step, windows/s, peak memory, launches as derived), their outputs
     equal;
  OPT. the options variant: ldm.yaml's UNet with scale-shift norm,
     resampling outside the resblocks (a stride-2 convolution down,
     nearest + convolution up) and dropout 0.1; aekl_eeg.yaml's AEKL with
     attention in its last level and both non-local blocks. Tiny (the
     tiny sampler's widths, fp32), card against CPU: a 4-step sampler plus
     decode at the model bound, one stage-2 step (loss at the model bound,
     each gradient within 2e-3 of its leaf's largest) and one stage-1
     step (``hold_tiny_stage1``, the AEKL's leaves in the JAX layout);
     then at full width one DDIM step at batch 64, one stage-2 step at
     batch 1024 and one stage-1 step at batch 2048 (halved until it fits;
     its 40 K1 and 40 K3 launches all in the cluster form), each with its
     launches as derived from the modules (a scale-shift chain 2 runs K1
     without SiLU, every chain 1 K2), their new kernel
     shapes held in fp32 and bf16 as phase 3's; then DDIM-200 batches of
     64, three of each sampler in turns (median windows/s each), and each
     training step's median ms and peak memory;
  MESH. ``torch.distributed`` over NCCL at world size 1: a stage-2 step
     (batch 256), a stage-1 step (batch 512), a DDIM-200 batch of 64 and a
     DeepSleepNet ``decode`` step (batch 64), each with ``make_mesh()`` and
     without, from the same weights and inputs under deterministic cuDNN,
     must be equal (``torch.equal``); the stage-2 and decode steps then
     take turns on the host clock: the ms the mesh adds per step;
  DIT. one full-width DiT-XL/2 forward in bf16 as a guided DPM++ step of 64
     windows runs it (128 rows of 384 tokens at 1152, inference mode): K4's
     launches, counted from zero, must be its 57 passes (2 depth + 1);
     K4 is then held to the composed ops at the three forms of that path
     (block 0's pass with nothing pending, the gated residual written
     back, the final layer's), y in fp32 and in bf16 within one ulp of its
     dtype, x_new within 1e-6 of max |x|;
  8. timings: each kernel at each shape of its path in bf16 (the
     reconstruction's K1 and the v1 paths in fp32, as they run): kernel,
     plain version, one-PyTorch-call yardstick (``library_ms``), each
     eager (per call in a loop, host cost included where it exceeds the
     device's) and as device time (the same calls
     captured in a CUDA graph; ``graph_ms``, ``plain_graph_ms``,
     ``library_graph_ms``; for K3's library, an autograd backward, the
     graph holds the aten ops it runs), and the bound; for K2 also the
     time of its weight re-layout (``fused_resblock.conv_tiles``), which
     the wrapper caches per weight; the copies K3's wrapper makes of a
     strided dy in one training step of each stage, and their time;
  9. profile: model build and one AEKL decode on the host clock; the PSD's
     scipy import (fresh process) and DPSS taper solve; five full-width
     DDIM steps on the host clock, then again under torch.profiler: device
     time per step by kernel, and the device's busy share of the wall time;
     one full-width training step of each stage the same way; five
     full-width DM DDIM steps at batch 64, ``impute``'s RePaint steps at
     batch 16 in signal and in latent mode (``repaint_profile``: twenty on
     the host clock, five under the profiler) and one DM training step at
     batch 512 the same way.

The line before the device line at the end is one JSON object with a row
per kernel and path: launches in one run of the path (K1: a sampler
batch, a stage-2 and a stage-1 training step, a DPM++2M-20 batch, a
reconstruction batch, a guided DPM++2M-20 request, a DM DDIM-200 batch,
a DM training step, band-eval's batch-512 reconstruction, a v1 encoder
step, a v1 DDPM step, a v1 ancestral batch, an int8 DDIM-200 batch, a
long-window DDIM-50 batch, an options DDIM-200 batch, an options stage-2
step and an attention stage-1 step; K2: a sampler batch, a DPM++2M-20
batch, a guided DPM++2M-20 request, a DM DDIM-200 batch, a v1 ancestral
batch (fp32), a long-window DDIM-50 batch and an options DDIM-200 batch;
K3: a stage-2, a stage-1, a DM, a v1 encoder, a v1 DDPM, an options
stage-2 and an attention stage-1 training step; K4: a DiT guided DPM++
step, its plain version and library yardstick both the composed ops, its
bound 679.5 MB a written-back pass at 3.35 TB/s; K5: an LDM and a DM DDIM
step, its library yardstick SDPA on contiguous q, k and v; B2, B3: on no
path), its error and
its times (each shape's time times its launches in that run, summed),
and for K1, K3 and B2 its launches by form (``forms``: on_chip, cluster,
streaming or three_pass, as the launchers report them);
the last line is
{"ok": true, "device": {...}}. Per-shape details go to
chiprun_out/chip_smoke_report.json. Any failure raises and the script
exits non-zero without the last line.

``python3 chip_smoke.py --only K2`` is the quick loop for K2 alone:
phases 1 and 2, the DDIM steps at batch 64 of the LDM and of the DM
that record K2's shapes and launches (the counts checked against the
configuration), K2's fp32 and bf16 checks at those shapes and at B3's,
and the phase-8 timings of K2 (paths "DDIM step", "DM DDIM step", "v1
ancestral step" in fp32 and "long-window DDIM step": each shape's time
times the step's measured launches at it) and B3, then one ``k2-shape``
line per shape of each path (fp32 at every v1 ancestral shape, bf16 at
the others): device us per call from the CUDA graph, eager us, the bound
and the share of the bound. It prints the kernels' JSON line and writes
chiprun_out/chip_smoke_k2_report.json, but never the {"ok": ...} line,
and exits non-zero on any failure.

``python3 chip_smoke.py --only GN`` is the same loop for K1, K3 and B2,
and the quick loop of their cluster form: phases 1 and 2, the sampler's
warm-up call (one DDIM step and the decode), one full-width training
step of each stage and of the DM, one DDIM step of the DM and one
reconstruction batch, whose K1 and K3 launches are checked against the
configuration, and the attention AEKL's stage-1 step of OPT at batch
2048; the stage-1 steps and the reconstruction batch must take the
cluster form at every K1 and K3 launch (``read_forms()``); K1's, K3's
and B2's fp32 and bf16 checks at those shapes and at B2's (with the v1
steps', the long window's and the int8 step's); the phase-8 timings of
K1 (paths "DDIM step", "train step", "stage-1 step", "reconstruction
batch", "DM train step", the v1 paths, "int8 DDIM step", "long-window
DDIM step" and "attention stage-1 step"), K3 ("train step", "stage-1
step", "DM train step", the v1 steps, "attention stage-1 step") and B2,
each K1, K3 and B2 row with its launches by form (``forms``), and of
K3's strided-dy copies. The report goes to chip_smoke_gn_report.json in
the output directory, as the other loops'; no {"ok": ...} line.

``python3 chip_smoke.py --only K4``: phases 1 and 2, DIT, then K4's
phase-8 timings on its path. Report in chiprun_out/chip_smoke_k4_report.json;
no {"ok": ...} line.

``python3 chip_smoke.py --only K5``: phases 1 and 2, one DDIM step of the
LDM and of the DM at batch 64, each of whose UNet attentions must launch
K5 (``require_k5``, which every run applies to those steps), K5's checks at
their shapes (B 64, one head of 512, L 192 and 768), then its timings per
step beside its bound, its plain version and SDPA on contiguous q, k and v
(``k5-shape`` lines). Report in chiprun_out/chip_smoke_k5_report.json; no
{"ok": ...} line.

``python3 chip_smoke.py --only OPT``: phases 1 and 2, OPT (its new
shapes checked from scratch) and MESH, then the phase-8 timings of OPT's
rows. Report in chiprun_out/chip_smoke_opt_report.json; no {"ok": ...}
line.
"""
from __future__ import annotations

import collections
import copy
import csv
import itertools
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from sleepgen_torch.__main__ import main as sleepgen_torch_main  # noqa: E402
from sleepgen_torch.cli.compute_fid import load_usleep  # noqa: E402
from sleepgen_torch.cli.compute_mmds import load_aekl, reconstruction_scores  # noqa: E402
from sleepgen_torch.cli.run_sleep_decode import load_staged_dataset, split_recordings  # noqa: E402
from sleepgen_torch.diffusion.schedules import NoiseSchedule  # noqa: E402
from sleepgen_torch.diffusion.ddpm_v1 import DDPMTables, p_sample, p_sample_loop  # noqa: E402
from sleepgen_torch.config import Config, DiTConfig  # noqa: E402
from sleepgen_torch.data.dataset import WindowDataset, load_split  # noqa: E402
from sleepgen_torch.data.edf import write_edf  # noqa: E402
from sleepgen_torch.data.staging import (STAGE_DESCRIPTIONS, balanced_class_weights,  # noqa: E402
                                         center_label, make_synthetic_staged, sequence_indices)
from sleepgen_torch.data.synthetic import (make_synthetic_dataset, write_ids_csv,  # noqa: E402
                                           write_synthetic_npy_tree)
from sleepgen_torch.data.transforms import BORDER_PAD, center_crop_valid, to_bcl  # noqa: E402
from sleepgen_torch.eval.bands import EEG_BANDS, filter_band  # noqa: E402
from sleepgen_torch.eval.fid import frechet_distance, usleep_fid_features  # noqa: E402
from sleepgen_torch.eval.msssim import ms_ssim_1d  # noqa: E402
from sleepgen_torch.eval.psd import dpss_tapers  # noqa: E402
from sleepgen_torch.kernels import _build, adaln, attention, fused_resblock, group_norm  # noqa: E402
from sleepgen_torch.nn.chambon import SleepStagerChambon2018, TimeDistributedStager  # noqa: E402
from sleepgen_torch.nn.aekl_v1 import AutoencoderKLV1  # noqa: E402
from sleepgen_torch.nn.discriminator import DiscriminatorV1  # noqa: E402
from sleepgen_torch.nn.deepsleepnet import DeepSleepNet  # noqa: E402
from sleepgen_torch.nn.dit import DiT1d  # noqa: E402
from sleepgen_torch.nn.layers import AttentionBlock1d, GroupNorm32, cast_compute_dtype  # noqa: E402
from sleepgen_torch.nn.quant import QuantConv1d, act_quantize, int8_conv_accumulate  # noqa: E402
from sleepgen_torch.nn.unet1d import TimestepResBlock, UNet1d  # noqa: E402
from sleepgen_torch.nn.usleep import USleep  # noqa: E402
from sleepgen_torch.sample.sample_ldm import (DTYPES, build_aekl, build_dm,  # noqa: E402
                                              build_models, build_unet, dm_sampling_schedule,
                                              sample_dm_trials, sample_ldm_trials,
                                              sampling_schedule)
from sleepgen_torch.sample.samplers import (cond_model_fn, ddim_sample_loop,  # noqa: E402
                                             ddpm_inpaint_loop, impute_dm, impute_ldm,
                                             latent_observed_mask)
from sleepgen_torch.serve import SamplerService  # noqa: E402
from sleepgen_torch.train import common as C  # noqa: E402
from sleepgen_torch.train import decode as DEC  # noqa: E402
from sleepgen_torch.train import train_aekl as A  # noqa: E402
from sleepgen_torch.train import train_dm as D  # noqa: E402
from sleepgen_torch.train import train_ldm as T  # noqa: E402
from sleepgen_torch.train import train_v1 as V  # noqa: E402
from sleepgen_torch.utils import profiling  # noqa: E402
from sleepgen_torch.utils.weights import (aekl_state_from_jax, aekl_state_to_jax,  # noqa: E402
                                          aekl_v1_state_from_jax, aekl_v1_state_to_jax,
                                          flax_init_state, lecun_normal_state, load_numpy_state,
                                          load_params_npz, save_params_npz, seeded_state_dict,
                                          unet_state_to_jax)

# Published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and
# fp32 CUDA-core operations/s.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
GN_OPS_PER_ELEMENT = 12  # stats 4, normalise + affine 4, SiLU 4
# backward: xhat 2, z 2, sigmoid 3, dz 5, dxhat 1, row sums 3, dx 4
GN_BWD_OPS_PER_ELEMENT = 20
ADALN_OPS_PER_ELEMENT = 10  # gated residual 2, mean 1, variance 3, modulation 4
BATCH, STEPS, SEED = 64, 200, 0
TIMED_BATCHES = 3
TRAIN_BATCH = 1024  # ldm.yaml
TRAIN_EPOCHS = 7  # one step each; the first is not timed
VALID_WINDOWS = 64
AEKL_CONFIG = ROOT / "sleepgen" / "configs" / "aekl_eeg.yaml"  # read as YAML
AEKL_BATCH = 2048  # aekl_eeg.yaml
DPM_STEPS = 20  # the JAX package's fast path, sleepgen/cli/sample_trials.py:22-24
EVAL_WINDOWS = 1024  # E2's test split, and the samples scored against it
SERVE_CLASSES = 5  # the sleep stages W, N1, N2, N3, REM
SERVE_STAGE, SERVE_SCALE = 2, 2.0  # S1 and S2's requests: stage 2, guided at 2.0
SEED_ALONE = 5  # S2: served alone, against its place in a batch of 64
# S2: bound on |seed alone - seed in a batch| after 20 bf16 steps and the
# decode, as a share of the batch's largest |value|: four bf16 roundings
ALONE_BOUND = 2.0**-6
SPIN_S = 1.5  # S2: seconds of card work queued ahead of sample_async (a request queues in < 0.5)
DM_CONFIG = ROOT / "sleepgen" / "configs" / "dm.yaml"  # read as YAML
DM_TRAIN_BATCH = 512  # dm.yaml; train-dm peaks at 69.90 GiB at it on an H100 80GB
DM_TABLE = 1000  # sample-dm's default --num_inference_steps: the sampling table's length
IMPUTE_BATCH, IMPUTE_MASK = 16, (1200, 600)  # impute's default batch; (mask_start, mask_len)
DECODE_BATCH = 64  # the decode CLI's --batch_size
# D2: 40 nights of 1,000 scored 30 s epochs, as a Sleep-EDFx cassette night
# holds after the +-30 min crop: 40 x 3.0 M samples at 100 Hz
DECODE_RECORDINGS, DECODE_NIGHT_EPOCHS = 40, 1000
DECODE_EPOCHS = 2
DECODE_HOLD_LR = 1e-4  # D1's AdamW rate: a small first step, as the tiny stage-1 trainer's
DECODE_PROFILE_STEPS = 20
BAND_EVAL_WINDOWS = 512  # band-eval's --max_windows, reconstructed in one call
HAVE = {}  # matplotlib and pandas on this machine (phase_modules)

K1_SRC = "sleepgen_torch/csrc/group_norm_silu.cu"  # + the shared gn_stats.cu
K2_SRC = "sleepgen_torch/csrc/gn_silu_conv3.cu"
K3_SRC = "sleepgen_torch/csrc/group_norm_silu_bwd.cu"
K1_REPLACES = "sleepgen/pallas_kernels/group_norm.py:126"
K2_REPLACES = "sleepgen/pallas_kernels/fused_resblock.py:142"
K3_REPLACES = "sleepgen/pallas_kernels/group_norm.py:226"
B2_REPLACES = "sleepgen/pallas_kernels/group_norm.py:159"
B3_REPLACES = "sleepgen/pallas_kernels/fused_resblock.py:180"
K4_SRC = "sleepgen_torch/csrc/adaln_modulate.cu"
K5_SRC = "sleepgen_torch/csrc/attention.cu"
K5_REPLACES = "none: the JAX package's attention is jnp einsums, sleepgen/nn/layers.py:236-239"
DIT_PATH = "DiT guided DPM++ step"  # one forward of 64 windows and their null-label rows
# B2's long window, (B, C, L, G, silu, dtype) in the port's layout
B2_SHAPES = [(16, 32, 49152, 1, True, "torch.bfloat16")]
# B3 at the Pallas test shapes (tests/test_pallas_kernels.py:122-145) and one
# sampler shape, (B, C_in, C_out, L, G, dtype)
B3_SHAPES = [(2, 32, 64, 96, 32, "torch.bfloat16"), (3, 16, 16, 64, 8, "torch.bfloat16"),
             (2, 32, 32, 128, 1, "torch.bfloat16"), (64, 512, 512, 192, 32, "torch.bfloat16")]


START = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One phase line, with the seconds since the script started (``at_s``)."""
    fields = {"at_s": f"{time.perf_counter() - START:.1f}", **fields}
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def flagship_config(steps: int) -> Config:
    cfg = Config()  # UNet mc 128 [1,2,4] attn [8,4] G 32, AEKL [32,32,64], bf16
    cfg.unet.image_size = 768
    cfg.diffusion.num_inference_steps = steps
    cfg.train.batch_size = TRAIN_BATCH
    return cfg


def tiny_config(steps: int) -> Config:
    cfg = Config()
    cfg.dtype = "float32"
    cfg.unet.model_channels, cfg.unet.channel_mult = 32, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.unet.image_size = 64
    cfg.aekl.num_channels = [4, 4, 8]
    cfg.diffusion.num_inference_steps = steps
    return cfg


def seeded_weights(cfg: Config, seed: int):
    lc = cfg.aekl.latent_channels
    with torch.device("meta"):
        unet, ae = build_unet(cfg, lc, lc), build_aekl(cfg)
    return seeded_state_dict(unet, seed), seeded_state_dict(ae, seed + 1)


def gn_counts(cfg: Config) -> dict:
    """The UNet's resblocks that do not resample (``plain``), those that do,
    its attention blocks and GroupNorms, and the AEKL encoder's GroupNorms
    (two per resblock and norm_out)."""
    u, a = cfg.unet, cfg.aekl
    levels, nrb = len(u.channel_mult), u.num_res_blocks
    plain = levels * nrb + 2 + levels * (nrb + 1)
    resampling = 2 * (levels - 1)
    attn = 1 + sum((nrb + nrb + 1) for level in range(levels)
                   if 2**level in u.attention_resolutions)
    return dict(plain=plain, resampling=resampling, attn=attn,
                unet_gn=2 * (plain + resampling) + attn + 1,
                coder_gn=2 * len(a.num_channels) * a.num_res_blocks + 1)


def expected_launches(cfg: Config, unet_forwards: int, decodes: int) -> dict:
    """Kernel launches of the sampler, derived from the configuration: K2
    runs both chains of every plain resblock and chain 2 of every
    resampling one; K1 runs chain 1 of the resampling resblocks, every
    attention norm and the UNet's output norm, and every AEKL decoder
    GroupNorm."""
    n = gn_counts(cfg)
    return {"K1": unet_forwards * (n["resampling"] + n["attn"] + 1) + decodes * n["coder_gn"],
            "K2": unet_forwards * (2 * n["plain"] + n["resampling"])}


def expected_train_launches(cfg: Config, steps: int, eval_batches: int,
                            encodes: int = 0) -> dict:
    """Kernel launches of training, derived from the configuration. A
    training step runs K1 at every UNet and encoder GroupNorm and K3 at
    every UNet GroupNorm, and no K2 (it has no backward); an eval batch
    runs the UNet without autograd (the sampler's K1 and K2) and the
    encoder; the scale factor is one more encode."""
    n = gn_counts(cfg)
    unet_eval = expected_launches(cfg, 1, 0)
    return {"K1": steps * (n["unet_gn"] + n["coder_gn"])
            + eval_batches * (unet_eval["K1"] + n["coder_gn"]) + encodes * n["coder_gn"],
            "K2": eval_batches * unet_eval["K2"],
            "K3": steps * n["unet_gn"]}


def stage1_config() -> Config:
    """``aekl_eeg.yaml`` as it stands: AEKL [32, 32, 64], latent 1, G 1;
    PatchDiscriminator 3 layers x 64 channels; batch 2048; bf16."""
    cfg = Config.from_yaml(AEKL_CONFIG)
    if (cfg.train.batch_size, cfg.dtype, cfg.aekl.norm_num_groups) != (AEKL_BATCH, "bfloat16", 1):
        raise AssertionError(f"{AEKL_CONFIG}: batch {cfg.train.batch_size}, dtype {cfg.dtype}, "
                             f"G {cfg.aekl.norm_num_groups}")
    return cfg


def tiny_stage1_config() -> Config:
    """Tiny widths in fp32 (AEKL [4, 4, 8], PatchDiscriminator 3 x 8) with
    Adam at 1e-4 for G and D: a small first step keeps the second step's
    gradients on the two devices close, however the first's signs
    rounded."""
    cfg = tiny_config(steps=4)
    cfg.discriminator.num_channels = 8
    cfg.losses.optimizer_g_lr = cfg.losses.optimizer_d_lr = 1e-4
    return cfg


def expected_stage1_launches(cfg: Config, steps: int, eval_batches: int) -> dict:
    """Kernel launches of stage-1 training, derived from the configuration:
    a step runs K1 at every GroupNorm of the AEKL's encoder and decoder and
    K3 at each for its gradient; an eval batch (the reconstruction) runs
    K1 at each; the discriminator has none; no K2."""
    n = 2 * gn_counts(cfg)["coder_gn"]
    return {"K1": (steps + eval_batches) * n, "K2": 0, "K3": steps * n}


def read_counts() -> dict:
    c = profiling.counters()
    return {"K1": c["k1.launches"], "K2": c["k2.launches"], "K3": c["k3.launches"]}


def read_relayouts() -> int:
    """K2's weight re-layouts since the last ``profiling.reset()``."""
    return profiling.counters()["k2.relayouts"]


def read_forms() -> dict:
    """K1's and K3's launches by the form each launcher reported, those
    counted: {"K1_cluster": n, "K3_three_pass": m, ...}."""
    out = {}
    for name, n in profiling.counters().items():
        kid, sep, form = name.partition(".form.")
        if sep and n:
            out[f"{kid.upper()}_{form}"] = n
    return out


def read_shapes() -> dict:
    """Launches by shape of each kernel, (``K3_strided_dy``) K3's calls
    whose dy came strided, by shape and dy's strides, and (``forms``) K1's
    and K3's launches by form."""
    return {"K1": profiling.keyed("k1.launch_shapes"), "K2": profiling.keyed("k2.launch_shapes"),
            "K3": profiling.keyed("k3.launch_shapes"),
            "K3_strided_dy": profiling.keyed("k3.strided_dy_shapes"), "forms": read_forms()}


def require_k2_tma(path: str, counts: dict, forms: dict) -> None:
    """Raise unless every K2 launch of the path (``counts``) loaded x through
    the tensor map (``k2.form.tma``, as ``read_forms()`` read after it)."""
    if forms.get("K2_tma", 0) != counts["K2"] or forms.get("K2_elem", 0):
        raise AssertionError(f"{path}: K2 launches {counts['K2']}, by form {forms}")


def attention_blocks(cfg: Config) -> int:
    """The UNet's attention blocks a forward: one after each resblock of a
    level whose downsampling factor is in ``attention_resolutions`` (its
    resblocks on the way down, one more on the way up), and the middle's."""
    u = cfg.unet
    return 1 + sum(2 * u.num_res_blocks + 1 for level in range(len(u.channel_mult))
                   if 2 ** level in u.attention_resolutions)


def k5_shapes(cfg: Config, batch: int) -> dict:
    """K5's launches a UNet forward by (B, heads, d, L), from the configuration."""
    u, out = cfg.unet, collections.Counter()
    deepest = len(u.channel_mult) - 1
    for level, m in enumerate(u.channel_mult):
        ch, length = u.model_channels * m, u.image_size // 2 ** level
        key = (batch, u.num_heads, ch // u.num_heads, length)
        if 2 ** level in u.attention_resolutions:
            out[key] += 2 * u.num_res_blocks + 1
        if level == deepest:
            out[key] += 1  # the middle block's
    return dict(out)


def require_k5(path: str, cfg: Config, forwards: int) -> None:
    """Raise unless K5 ran at every UNet attention of the path's forwards
    (``k5.launches`` since the last ``profiling.reset()``) and no attention
    was declined to SDPA."""
    c, want = profiling.counters(), attention_blocks(cfg) * forwards
    if (c["k5.launches"], c["k5.declined"]) != (want, 0):
        raise AssertionError(f"{path}: K5 launches {c['k5.launches']}, declined "
                             f"{c['k5.declined']}, expected {want} and 0")


def require_forms(path: str, counts: dict, forms: dict, form: str = "cluster") -> None:
    """Raise unless every K1 and K3 launch of the path (``counts``) took
    ``form``, as ``read_forms()`` read after it (``forms``)."""
    want = {f"{kid}_{form}": counts[kid] for kid in ("K1", "K3") if counts[kid]}
    if forms != want:
        raise AssertionError(f"{path}: launches by form {forms}, expected {want}")


# -- kernel inputs, references, yardsticks ------------------------------------

def k1_inputs(key, dtype, seed):
    b, c, l, g, silu, _ = key
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, c, l), generator=gen, device="cuda") + 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(c, generator=gen, device="cuda")
    return (x, scale, bias, g, 1e-6, silu)


def k2_inputs(key, dtype, seed):
    b, cin, cout, l, g, _ = key
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, cin, l), generator=gen, device="cuda") + 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(cin, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(cin, generator=gen, device="cuda")
    w = (torch.randn((cout, cin, 3), generator=gen, device="cuda") / (3 * cin) ** 0.5).to(dtype)
    bb = (0.1 * torch.randn(cout, generator=gen, device="cuda")).to(dtype)
    return (x, scale, bias, w, bb, g, 1e-6)


def k3_inputs(key, dtype, seed):
    """x, dy, scale, bias, the forward's stats (from K1), G, silu."""
    x, scale, bias, g, eps, silu = k1_inputs(key, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    stats = group_norm.group_norm_silu_forward(x, scale, bias, g, eps, silu)[1]
    return (x, dy, scale, bias, stats, g, silu)


def k1_library(x, scale, bias, g, eps, silu):
    y = F.group_norm(x, g, scale.to(x.dtype), bias.to(x.dtype), eps)
    return F.silu(y) if silu else y


def k2_library(x, scale, bias, w, bb, g, eps):
    h = F.silu(F.group_norm(x, g, scale.to(x.dtype), bias.to(x.dtype), eps))
    return F.conv1d(h, w, bb, padding=1)


def k3_library(x, dy, scale, bias, stats, g, silu):
    """The autograd backward of F.silu(F.group_norm(...)) at the same
    inputs: returns the call to time, the forward done outside it."""
    xr = x.detach().requires_grad_()
    w = scale.to(x.dtype).requires_grad_()
    b = bias.to(x.dtype).requires_grad_()
    y = F.group_norm(xr, g, w, b, 1e-6)
    y = F.silu(y) if silu else y
    return lambda: torch.autograd.grad(y, (xr, w, b), dy, retain_graph=True)


def k3_library_ops(x, dy, scale, bias, stats, g, silu):
    """The aten ops that autograd's backward of F.silu(F.group_norm(...))
    runs, called directly so that a CUDA graph can capture them:
    silu_backward, then native_group_norm_backward from the forward's
    saved mean and rstd. Returns the call to time, the forward done
    outside it."""
    b, c, l = x.shape
    w, bb = scale.to(x.dtype), bias.to(x.dtype)
    z, mean, rstd = torch.ops.aten.native_group_norm(x, w, bb, b, c, l, g, 1e-6)

    def run():
        dz = torch.ops.aten.silu_backward(dy, z) if silu else dy
        return torch.ops.aten.native_group_norm_backward(dz, x, mean, rstd, w, b, c, l, g,
                                                         [True, True, True])
    return run


def k1_bound(key, dtype):
    b, c, l, *_ = key
    n = b * c * l
    t_bytes = (2 * n * dtype.itemsize + 8 * c) / HBM_BYTES_PER_S
    t_ops = GN_OPS_PER_ELEMENT * n / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_bound(key, dtype):
    """The convolution's products (bf16 on the tensor cores; fp32, which
    K2 computes exactly with FMAs, on the CUDA cores) and the GroupNorm's
    fp32 work on the CUDA cores can overlap, so the least time is the
    largest of the three times, not a sum."""
    b, cin, cout, l, *_ = key
    t_bytes = ((b * cin * l + cout * cin * 3 + cout + b * cout * l) * dtype.itemsize
               + 8 * cin) / HBM_BYTES_PER_S
    rate = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_ops = max(2 * 3 * b * l * cin * cout / rate,
                GN_OPS_PER_ELEMENT * b * cin * l / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k3_bound(key, dtype):
    """Read x and dy once, write dx once, plus the (B, G) stats and the
    (C,) scale, bias, dscale and dbias in fp32."""
    b, c, l, g, *_ = key
    n = b * c * l
    t_bytes = (3 * n * dtype.itemsize + 8 * b * g + 16 * c) / HBM_BYTES_PER_S
    t_ops = GN_BWD_OPS_PER_ELEMENT * n / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


K4_ULP_BITS = {torch.bfloat16: 7, torch.float32: 23}  # mantissa bits of y's dtype


def k4_inputs(key, dtype, seed):
    """The DiT's pass at (B, T, D, form): x (B, T, D) fp32 off zero; shift,
    scale and gate chunks of a block's (B, 6 D) adaLN projection in
    ``dtype`` (the final layer's shift and scale of a (B, 2 D) one); h (B,
    T, D) in ``dtype``; form "first" (block 0's attention: nothing
    pending), "residual" (the gated residual written back) or "final" (not
    written back). Returns ``adaln.adaln_modulate``'s arguments."""
    b, t, d, form = key
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = 3.0 * torch.randn((b, t, d), generator=gen, device="cuda") + 0.5
    mods = (0.3 * torch.randn((b, 6 * d), generator=gen, device="cuda")).to(dtype).chunk(6, 1)
    shift, scale, gate = mods[3], mods[4], mods[5]
    if form == "final":
        shift, scale = (0.3 * torch.randn((b, 2 * d), generator=gen, device="cuda")).to(
            dtype).chunk(2, 1)
    h = torch.randn((b, t, d), generator=gen, device="cuda").to(dtype)
    return (x, shift, scale, dtype, None if form == "first" else (h, gate), form != "final")


def k4_plain(x, shift, scale, dtype, pending, write_back):
    """The composed ops of the same pass (a new x_new, x untouched)."""
    return adaln.adaln_modulate_reference(x, shift, scale, dtype, pending)


def k4_bound(key, dtype):
    """Read x (and h where a branch is pending) once, write y (and x_new
    where it is written back) once, plus the (B, D) gate, shift and scale."""
    b, t, d, form = key
    isz = dtype.itemsize
    per_element = {"first": 4 + isz, "residual": 4 + isz + 4 + isz, "final": 4 + isz + isz}[form]
    t_bytes = (b * t * d * per_element + 3 * b * d * isz) / HBM_BYTES_PER_S
    t_ops = ADALN_OPS_PER_ELEMENT * b * t * d / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_k4(key) -> dict:
    """K4 against the composed ops at one shape, with y in fp32 and in bf16:
    y within one unit in the last place of its dtype (beyond an fp32 floor
    of 1e-6 of its largest |value|: the composed ops' Welford statistics
    and unfused residual round otherwise than K4's two-pass statistics and
    FMA), x_new within 1e-6 of max |x| where written back, x untouched
    elsewhere."""
    out = {}
    for dtype, seed in ((torch.float32, 1), (torch.bfloat16, 2)):
        args = k4_inputs(key, dtype, seed)
        x = args[0]
        want_x, want_y = k4_plain(*args)
        x_before, x_max = x.clone(), float(x.abs().max())
        got_x, got_y = adaln.adaln_modulate(*args)
        torch.cuda.synchronize()
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        if key[3] == "residual":
            x_err = float((got_x - want_x).abs().max())
            if got_x is not x or x_err > 1e-6 * x_max:
                raise AssertionError(f"K4 {tag} at {key}: x_new max abs err {x_err}")
        elif not torch.equal(x, x_before) or (got_x is None) != (key[3] == "final"):
            raise AssertionError(f"K4 {tag} at {key}: the stream changed or x_new came back")
        got, want = got_y.float(), want_y.float()
        _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
        ulp = torch.ldexp(torch.ones_like(got), e - 1 - K4_ULP_BITS[dtype])
        err = (got - want).abs()
        excess = float((err - ulp - 1e-6 * float(want.abs().max())).max())
        if got_y.dtype != dtype or excess > 0:
            raise AssertionError(f"K4 {tag} at {key}: y beyond one ulp by {excess}")
        out[f"{tag}_max_abs_err"] = float(err.max())
        del args, x, want_x, want_y, x_before, got_x, got_y, got, want, e, ulp, err
    return out


def k5_inputs(key, dtype, seed):
    """The UNet's attention at (B, heads, d, L): qkv (B, 3 heads d, L) with
    N(0, 1) entries in ``dtype`` (the sampling cells' bf16), as the qkv
    convolution hands it over after a GroupNorm."""
    b, heads, d, l = key
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((b, 3 * heads * d, l), generator=gen, device="cuda").to(dtype), heads)


def k5_library(qkv, heads):
    """SDPA on contiguous (B, heads, L, d) q, k and v, scaled as the UNet's:
    the yardstick, which the port never calls in this form. The copies are
    made here, outside the timed call."""
    b, c3, l = qkv.shape
    d = c3 // (3 * heads)
    q, k, v = (t.transpose(-1, -2).contiguous()
               for t in qkv.reshape(b, heads, 3 * d, l).split(d, dim=2))
    return lambda: F.scaled_dot_product_attention(q, k, v)


def k5_bound(key, dtype):
    """Both products' operations at the bf16 peak, or q, k and v read and
    the output written once."""
    b, heads, d, l = key
    t_ops = 4 * b * heads * l * l * d / BF16_TC_OPS_PER_S
    t_bytes = 4 * b * heads * d * l * dtype.itemsize / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_k5(key) -> dict:
    """K5 against its plain version at one shape in bf16 (its only dtype):
    within 2^-5 (|ref| + rms(ref)), the plain version rounding the scaled q
    and k to bf16 before their product (tests/test_torch_cuda_kernels.py::
    _hold_k5 gives the reason)."""
    qkv, heads = k5_inputs(key, torch.bfloat16, 2)
    with torch.inference_mode():
        got = attention.fused_attention(qkv, heads).float()
        want = attention.attention_reference(qkv, heads).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= 2.0**-5 * (want.abs() + want.square().mean().sqrt())).all()):
        raise AssertionError(f"K5 at {key}: max abs err {float(err.max())}")
    return {"bf16_max_abs_err": float(err.max())}


KERNELS = {
    "K1": dict(name="group_norm_silu", src=K1_SRC, replaces=K1_REPLACES, inputs=k1_inputs,
               kernel=group_norm.group_norm_silu, plain=group_norm.group_norm_silu_reference,
               library=k1_library, bound=k1_bound, fp32_tol=(1e-5, 2e-6)),
    "K2": dict(name="gn_silu_conv3", src=K2_SRC, replaces=K2_REPLACES, inputs=k2_inputs,
               kernel=fused_resblock.gn_silu_conv3,
               plain=fused_resblock.gn_silu_conv3_reference, library=k2_library,
               bound=k2_bound, fp32_tol=(2e-4, 2e-4)),
    "K3": dict(name="group_norm_silu_backward", src=K3_SRC, replaces=K3_REPLACES,
               inputs=k3_inputs, kernel=group_norm.group_norm_silu_backward,
               plain=group_norm.group_norm_silu_backward_reference, library=k3_library,
               bound=k3_bound, fp32_tol=(1e-4, 1e-5)),
    "B2": dict(name="group_norm_silu_tiled", src=K1_SRC, replaces=B2_REPLACES,
               inputs=k1_inputs, kernel=group_norm.group_norm_silu_tiled,
               plain=group_norm.group_norm_silu_reference, library=k1_library,
               bound=k1_bound, fp32_tol=(2e-5, 2e-5)),
    "B3": dict(name="fused_gn_silu_conv3", src=K2_SRC, replaces=B3_REPLACES,
               inputs=k2_inputs, kernel=fused_resblock.fused_gn_silu_conv3,
               plain=fused_resblock.gn_silu_conv3_reference, library=k2_library,
               bound=k2_bound, fp32_tol=(2e-4, 2e-4)),
    # held to one ulp of y's dtype by check_k4; the composed ops are both
    # its plain version and its library yardstick
    "K4": dict(name="adaln_modulate", src=K4_SRC, replaces="none", inputs=k4_inputs,
               kernel=adaln.adaln_modulate, plain=k4_plain, library=k4_plain,
               bound=k4_bound, fp32_tol=None),
    # bf16 only, held by check_k5; its library yardstick is SDPA on
    # contiguous q, k and v, made before the timed calls (k5_library)
    "K5": dict(name="attention", src=K5_SRC, replaces=K5_REPLACES, inputs=k5_inputs,
               kernel=attention.fused_attention, plain=attention.attention_reference,
               library=k5_library, bound=k5_bound, fp32_tol=None),
}


def bf16_tolerance(kid: str, ref: torch.Tensor) -> torch.Tensor:
    rtol = 2.0**-8
    if kid in ("K2", "B3"):
        return rtol * ref.abs() + 4 * rtol * ref.square().mean().sqrt()
    return rtol * ref.abs() + 1e-5


def _compare(kid: str, key, got, want, bf16: bool) -> float:
    """Max abs error of got against want, raising past the kernel's bound.
    For K3, got and want are (dx, dscale, dbias): dx is held like an
    output, dscale and dbias to the fp32 bound with atol scaled by
    sqrt(B L)."""
    rtol, atol = KERNELS[kid]["fp32_tol"]
    if kid == "K3":
        (dx, *params), (dx_ref, *params_ref) = got, want
        b, l = key[0], key[2]
        for g, w in zip(params, params_ref):
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol * (b * l) ** 0.5,
                                       msg=lambda m: f"K3 dscale/dbias at {key}: {m}")
        err = max(float((g - w).abs().max()) for g, w in zip(params, params_ref))
        got, want = dx, dx_ref
    else:
        err = 0.0
    if bf16:
        e = (got.float() - want.float()).abs()
        if not bool((e <= bf16_tolerance(kid, want.float())).all()):
            raise AssertionError(f"{kid} bf16 at {key}: max abs err {float(e.max())}")
    else:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{kid} fp32 at {key}: {m}")
    return max(err, float((got.float() - want.float()).abs().max()))


def check_kernel(kid: str, key) -> dict:
    """The kernel against its plain version at one shape: fp32 inputs, then
    bf16 inputs against the plain version on their fp32 copies."""
    if kid == "K4":
        return check_k4(key)
    if kid == "K5":
        return check_k5(key)
    spec = KERNELS[kid]
    out = {}
    for dtype, seed in ((torch.float32, 1), (torch.bfloat16, 2)):
        args = spec["inputs"](key, dtype, seed)
        got = spec["kernel"](*args)
        torch.cuda.synchronize()
        up = [a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a
              for a in args]
        want = spec["plain"](*up)
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        out[f"{tag}_max_abs_err"] = _compare(kid, key, got, want, dtype == torch.bfloat16)
    return out


def time_ms(fn, args, reps: int, graph: bool = True) -> tuple:
    """ms of one call, two ways: (eager, graph). Eager: ``reps`` calls in a
    loop between CUDA events, as a caller pays per call, its host cost
    included where the host is slower than the card (median of three
    loops). Graph: the same calls captured in one CUDA graph and
    replayed between the events (median of three replays), device time
    only. ``graph`` False (an autograd backward, which runs on the engine's
    own threads) gives no graph time (None); a capture that fails raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def median_of_three(run) -> float:
        times = []
        for _ in range(3):
            start.record()
            run()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / reps)
        return statistics.median(times)

    def loop() -> None:
        for _ in range(reps):
            fn(*args)

    eager = median_of_three(loop)
    if not graph:
        return eager, None
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        loop()
    replayed = median_of_three(cuda_graph.replay)
    del cuda_graph
    return eager, replayed


def free_card() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# -- phases --------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_modules() -> None:
    """Whether matplotlib (the report figures) and pandas can be imported
    here; the port needs neither."""
    import importlib.util

    HAVE.update({m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "pandas")})
    say("modules", **HAVE)


def phase_build() -> dict:
    t0 = time.perf_counter()
    logs = _build.build()
    _build.load()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", built=",".join(logs) or "cached")
    return logs


def full_trainer(cfg: Config, ae_state):
    """train_ldm's models, schedule and Adam on the card, and its train and
    eval steps (scale factor 1); returns (step function, eval function,
    schedule, latent shape)."""
    unet, ae, sched, opt = T.build_trainer(cfg, ae_state, cfg, "cuda")
    step = T.make_ldm_train_step(unet, ae, sched, opt, 1.0, DTYPES[cfg.dtype])
    evaluate = T.make_ldm_eval_step(unet, ae, sched, DTYPES[cfg.dtype])
    return step, evaluate, sched, (cfg.aekl.latent_channels, C.latent_length(cfg, 3072))


def train_windows(n: int, seed: int) -> torch.Tensor:
    ds = WindowDataset.from_raw(make_synthetic_dataset(n, 35.0, seed))
    return C.windows_to_device(ds.epoch_windows(np.random.default_rng(seed)),
                               torch.device("cuda"))


def eval_relayouts(step, step_inputs, evaluate, sched, latent_shape, cfg: Config) -> dict:
    """The trainer's eval batches (VALID_WINDOWS windows, K2 on the fp32
    masters under autocast): one that warms up (first-call costs and the
    re-layouts), one more training step that changes the weights, then
    two eval batches. The first after the step re-lays out each K2 weight
    once, the second none; the difference of their seconds (host clock)
    is what an eval, or an in-training sample, pays per weight update."""
    x = train_windows(VALID_WINDOWS, SEED + 2)
    gen = C.make_generator(cfg.train.seed, "cuda", C.EVAL_STREAM, 0)
    inputs = T.draw_step_inputs(gen, VALID_WINDOWS, latent_shape, sched.num_timesteps)
    per_forward = expected_launches(cfg, 1, 0)["K2"]
    seconds, relayouts = [], []
    for i in range(3):
        if i == 1:
            step(*step_inputs)
        profiling.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(x, 1.0, *inputs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        relayouts.append(read_relayouts())
        if read_counts()["K2"] != per_forward:
            raise AssertionError(f"eval batch: K2 launches {read_counts()['K2']}, "
                                 f"expected {per_forward}")
    if relayouts != [per_forward, per_forward, 0]:
        raise AssertionError(f"eval batches re-laid out {relayouts} K2 weights, "
                             f"expected [{per_forward}, {per_forward}, 0]")
    say("eval", windows=VALID_WINDOWS, relayouts=relayouts,
        **{f"ms_{i}": f"{v * 1e3:.3f}" for i, v in enumerate(seconds)},
        relayout_ms_per_update=f"{(seconds[1] - seconds[2]) * 1e3:.3f}")
    return dict(windows=VALID_WINDOWS, relayouts=relayouts, seconds=seconds,
                relayout_ms_per_update=(seconds[1] - seconds[2]) * 1e3)


def phase_train_step() -> tuple:
    """One full-width training step (batch 1024, bf16) with the counts set
    to 0 before and read after: they must equal those derived from the
    configuration, K2 none; then two eval batches (``eval_relayouts``).
    Returns the shapes the step gave K1 and K3, and the eval's record."""
    cfg = flagship_config(steps=1)
    _, ae_sd = seeded_weights(cfg, SEED)
    step, evaluate, sched, latent_shape = full_trainer(cfg, ae_sd)
    x = train_windows(TRAIN_BATCH, SEED)
    gen = C.make_generator(cfg.train.seed, "cuda", C.TRAIN_STREAM, 0)
    inputs = T.draw_step_inputs(gen, TRAIN_BATCH, latent_shape, sched.num_timesteps)
    profiling.reset()
    loss = step(x, *inputs)
    torch.cuda.synchronize()
    counts, shapes = read_counts(), read_shapes()
    want = expected_train_launches(cfg, steps=1, eval_batches=0)
    if counts != want or not bool(torch.isfinite(loss)):
        raise AssertionError(f"training step: launches {counts}, expected {want}, "
                             f"loss {float(loss)}")
    say("train-step", batch=TRAIN_BATCH, loss=f"{float(loss):.5f}", k1_launches=counts["K1"],
        k3_launches=counts["K3"], k2_launches=counts["K2"],
        k1_shapes=len(shapes["K1"]), k3_shapes=len(shapes["K3"]), **shapes["forms"])
    evals = eval_relayouts(step, (x, *inputs), evaluate, sched, latent_shape, cfg)
    del step, evaluate, x
    free_card()
    return counts, shapes, evals


def stage1_trainer(cfg: Config):
    """train_aekl's models and Adams on the card, and its train step."""
    ae, disc, opt_g, opt_d = A.build_trainer(cfg, "cuda")
    return A.make_train_step(ae, disc, opt_g, opt_d, cfg, DTYPES[cfg.dtype])


def stage1_inputs(cfg: Config, seed: int) -> tuple:
    """A full batch of windows in the compute dtype, as train_aekl casts
    them, and the encoder's eps of step 0."""
    x = train_windows(cfg.train.batch_size, seed).to(DTYPES[cfg.dtype])
    gen = C.make_generator(cfg.train.seed, "cuda", C.AEKL_STREAM, 0)
    eps = torch.randn((x.shape[0], cfg.aekl.latent_channels, C.latent_length(cfg, x.shape[-1])),
                      generator=gen, device="cuda")
    return x, eps


def phase_stage1_step() -> tuple:
    """One full-width stage-1 step (aekl_eeg.yaml, batch 2048, bf16) with
    the counts set to 0 before and read after: they must equal those
    derived from the configuration, K2 none, and the metrics must be
    finite. Returns the counts and the shapes the step gave K1 and K3,
    with the strided dy tensors K3's wrapper copied."""
    cfg = stage1_config()
    step = stage1_trainer(cfg)
    x, eps = stage1_inputs(cfg, SEED)
    profiling.reset()
    metrics = step(x, eps)
    torch.cuda.synchronize()
    counts, shapes = read_counts(), read_shapes()
    want = expected_stage1_launches(cfg, steps=1, eval_batches=0)
    values = {k: float(v) for k, v in metrics.items()}
    if counts != want or not all(np.isfinite(v) for v in values.values()):
        raise AssertionError(f"stage-1 step: launches {counts}, expected {want}, "
                             f"metrics {values}")
    require_forms("stage-1 step", counts, shapes["forms"])
    say("stage1-step", batch=cfg.train.batch_size, k1_launches=counts["K1"],
        k3_launches=counts["K3"], k2_launches=counts["K2"], k1_shapes=len(shapes["K1"]),
        k3_shapes=len(shapes["K3"]), **shapes["forms"],
        k3_strided_dy=sum(shapes["K3_strided_dy"].values()),
        **{k: f"{v:.5g}" for k, v in values.items()})
    del step, x, eps, metrics
    free_card()
    return counts, shapes


def recon_launches(cfg: Config, batches: int) -> dict:
    """K1 launches of ``compute-mmds``'s reconstruction: every GroupNorm of
    the AEKL's encoder and decoder per batch; no K2, no K3."""
    return {"K1": batches * 2 * gn_counts(cfg)["coder_gn"], "K2": 0, "K3": 0}


def eval_aekl(cfg: Config, ae_state) -> torch.nn.Module:
    """The AEKL as ``compute-mmds`` builds it: fp32, on the card, eval mode."""
    with torch.device("cuda"):
        return load_numpy_state(build_aekl(cfg), ae_state).eval()


def phase_recon_batch() -> tuple:
    """One ``compute-mmds`` reconstruction batch at full width (AEKL [32,
    32, 64], batch 64, fp32) with the counts set to 0 before and read
    after: 26 K1 launches as derived from the configuration, every score
    finite. Returns the counts and K1's shapes."""
    cfg = flagship_config(steps=1)
    _, ae_sd = seeded_weights(cfg, SEED)
    ae = eval_aekl(cfg, ae_sd)
    ds = WindowDataset.from_raw(make_synthetic_dataset(BATCH, 35.0, SEED + 6))
    windows = ds.epoch_windows(np.random.default_rng(SEED))
    profiling.reset()
    scores = reconstruction_scores(ae, windows, BATCH, torch.device("cuda"))
    counts, shapes = read_counts(), read_shapes()
    want = recon_launches(cfg, batches=1)
    if counts != want or scores.shape != (BATCH,) or not np.isfinite(scores).all():
        raise AssertionError(f"reconstruction batch: launches {counts}, expected {want}, "
                             f"scores {scores.shape}")
    require_forms("reconstruction batch", counts, shapes["forms"])
    say("recon-batch", batch=BATCH, k1_launches=counts["K1"], k1_shapes=len(shapes["K1"]),
        mean_ms_ssim=f"{scores.mean():.5f}", **shapes["forms"])
    del ae
    free_card()
    return counts, shapes


def say_dm_checks(results: dict, sample_shapes: dict, train_shapes: dict) -> None:
    """The DM's share of phase 3's checks: its shapes of each kernel, how
    many of K1's and K3's groups hold exactly ON_CHIP_MAX elements (the
    largest on-chip case) and how many more at G > 1 (the cluster form),
    and their largest errors. Raises if the DM's training step gave
    neither kind."""
    keys = {"K1": {**sample_shapes["K1"], **train_shapes["K1"]}, "K2": sample_shapes["K2"],
            "K3": train_shapes["K3"]}
    keys = {kid: ks for kid, ks in keys.items() if kid in results}
    sizes = [k[1] // k[3] * k[2] for kid in ("K1", "K3") for k in keys.get(kid, ())
             if k[3] > 1]
    at_max = sum(n == group_norm.ON_CHIP_MAX for n in sizes)
    above = sum(n > group_norm.ON_CHIP_MAX for n in sizes)
    if train_shapes["K3"] and not (at_max and above):
        raise AssertionError(f"DM shapes: {at_max} groups of ON_CHIP_MAX, {above} above")
    errs = [results[kid][k] for kid, ks in keys.items() for k in ks]
    say("check-dm", **{f"{kid.lower()}_shapes": len(ks) for kid, ks in keys.items()},
        groups_at_on_chip_max=at_max, groups_above_g_gt_1=above,
        fp32_max_abs_err=f"{max(r['fp32_max_abs_err'] for r in errs):.3e}",
        bf16_max_abs_err=f"{max(r['bf16_max_abs_err'] for r in errs):.3e}")


def phase_checks(tmp: Path, only: str | None = None) -> tuple:
    """The sampler's warm-up DDIM step, one training step of each stage and
    one reconstruction batch record the shapes each kernel gets on each
    path (the counts of the warm-up are discarded), then every kernel is
    checked at every shape,
    and B2 and B3 at theirs. The warm-up
    also pays the process's one-time costs (cuDNN plans, the import of
    scipy.signal for the PSD's tapers, which takes seconds), so phase 5
    times steady-state batches. ``only`` "K2": no training step, and only
    K2 and B3 are checked; the step's K2 launches must equal the count
    derived from the configuration. ``only`` "GN": only K1, K3 and B2 are
    checked, and the warm-up's K1 launches must equal the count derived
    from the configuration (the training steps' are checked always). Every
    K2 launch of the LDM's and the DM's DDIM step must load x through the
    tensor map (``require_k2_tma``)."""
    cfg = flagship_config(steps=1)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    profiling.reset()
    sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "warmup", 0, BATCH, BATCH)
    torch.cuda.synchronize()
    sample_counts, sample_shapes = read_counts(), read_shapes()
    require_k5("DDIM step", cfg, forwards=1)
    if only in ("K2", "GN"):
        kid = "K2" if only == "K2" else "K1"
        want = expected_launches(cfg, unet_forwards=1, decodes=1)[kid]
        if sample_counts[kid] != want:
            raise AssertionError(f"DDIM step: {kid} launches {sample_counts[kid]}, "
                                 f"expected {want}")
    dm_sample_counts, dm_sample_shapes = phase_dm_sample_step(tmp)
    require_k2_tma("DDIM step", sample_counts, sample_shapes["forms"])
    require_k2_tma("DM DDIM step", dm_sample_counts, dm_sample_shapes["forms"])
    if only == "K2":
        train_counts, train_shapes, evals = {}, {"K1": {}, "K3": {}}, {}
        stage1_counts, stage1_shapes = {}, {"K1": {}, "K3": {}}
        recon_counts, recon_shapes = {}, {"K1": {}}
        dm_train_counts, dm_train_shapes = {}, {"K1": {}, "K3": {}}
    else:
        train_counts, train_shapes, evals = phase_train_step()
        stage1_counts, stage1_shapes = phase_stage1_step()
        recon_counts, recon_shapes = phase_recon_batch()
        dm_train_counts, dm_train_shapes = phase_dm_train_step()
    v1_steps = phase_v1_steps()
    long_counts, long_shapes = phase_long_window_step()
    quant_counts, quant_shapes = ({}, {"K1": {}}) if only == "K2" else phase_quant_step(tmp)
    v1_shapes = {kid: {k: n for _, shp in v1_steps.values() for k, n in shp[kid].items()}
                 for kid in ("K1", "K2", "K3")}
    to_check = {"K1": {**sample_shapes["K1"], **train_shapes["K1"], **stage1_shapes["K1"],
                       **recon_shapes["K1"], **dm_sample_shapes["K1"], **dm_train_shapes["K1"],
                       **v1_shapes["K1"], **long_shapes["K1"], **quant_shapes["K1"]},
                "K2": {**sample_shapes["K2"], **dm_sample_shapes["K2"], **v1_shapes["K2"],
                       **long_shapes["K2"]},
                "K3": {**train_shapes["K3"], **stage1_shapes["K3"], **dm_train_shapes["K3"],
                       **v1_shapes["K3"]},
                "B2": dict.fromkeys(B2_SHAPES, 1), "B3": dict.fromkeys(B3_SHAPES, 1)}
    if only:
        keep = {"K2": ("K2", "B3"), "GN": ("K1", "K3", "B2")}[only]
        to_check = {kid: to_check[kid] for kid in keep}
    results = {}
    for kid, keys in to_check.items():
        results[kid] = {key: check_kernel(kid, key) for key in keys}
        free_card()
        say("check", kernel=KERNELS[kid]["name"], shapes=len(keys),
            fp32_max_abs_err=f"{max(r['fp32_max_abs_err'] for r in results[kid].values()):.3e}",
            bf16_max_abs_err=f"{max(r['bf16_max_abs_err'] for r in results[kid].values()):.3e}")
    if "K1" in results:
        say_dm_checks(results, dm_sample_shapes, dm_train_shapes)
    profiling.reset()
    return dict(sample=sample_shapes, sample_counts=sample_counts, train=train_shapes,
                train_counts=train_counts, evals=evals, stage1=stage1_shapes,
                stage1_counts=stage1_counts, recon=recon_shapes,
                recon_counts=recon_counts, dm_sample=dm_sample_shapes,
                dm_sample_counts=dm_sample_counts, dm_train=dm_train_shapes,
                dm_train_counts=dm_train_counts, v1=v1_steps, long=(long_counts, long_shapes),
                quant_step=(quant_counts, quant_shapes)), results


def phase_tiny(tmp: Path) -> None:
    cfg = tiny_config(steps=4)
    unet_sd, ae_sd = seeded_weights(cfg, SEED + 10)
    kw = dict(start_seed=0, stop_seed=4, batch_size=4, compute_psd=False)
    profiling.reset()
    card = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "tiny_card", device="cuda", **kw)
    counts = read_counts()
    cpu = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "tiny_cpu", device="cpu", **kw)
    want = expected_launches(cfg, unet_forwards=4, decodes=1)
    if counts != {**want, "K3": 0}:
        raise AssertionError(f"tiny sampler launches {counts}, expected {want}")
    np.testing.assert_allclose(card, cpu, rtol=2e-3, atol=2e-4,
                               err_msg="tiny sampler: card (kernels) vs CPU (plain)")
    say("tiny", shape=card.shape, max_abs_err=f"{np.abs(card - cpu).max():.3e}",
        k1_launches=counts["K1"], k2_launches=counts["K2"])


def phase_full(tmp: Path) -> dict:
    """Three full-width batches, each one call of the entry point as a
    user makes it (model build, 200 steps, decode, artifacts), with the
    counts set to 0 before and read after each."""
    cfg = flagship_config(steps=STEPS)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    want = expected_launches(cfg, unet_forwards=STEPS, decodes=1)
    seconds = []
    for i in range(TIMED_BATCHES):
        seeds = (i * BATCH, (i + 1) * BATCH)
        profiling.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "full", *seeds, BATCH)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches, shapes = read_counts(), read_shapes()
        if out.shape != (BATCH, 3000, 1) or not np.isfinite(out).all():
            raise AssertionError(f"full-width output {out.shape}, finite={np.isfinite(out).all()}")
        if launches != {**want, "K3": 0} or min(want.values()) == 0:
            raise AssertionError(f"batch {i}: launches {launches}, expected {want}")
        if not (tmp / "full" / f"sample_{seeds[1] - 1}.npy").exists():
            raise AssertionError("artifacts missing")
        say("full", batch=i, shape=out.shape, seconds=f"{seconds[-1]:.3f}",
            k1_launches=launches["K1"], k2_launches=launches["K2"], out_std=f"{out.std():.4f}")
    median = statistics.median(seconds)
    say("full", batches=TIMED_BATCHES, median_seconds=f"{median:.3f}",
        min_seconds=f"{min(seconds):.3f}", max_seconds=f"{max(seconds):.3f}",
        windows_per_s=f"{BATCH / median:.3f}")
    return dict(seconds=seconds, median_seconds=median, windows_per_s=BATCH / median,
                launches=launches, shapes=shapes)


def cold_batch(out_dir: str) -> None:
    """Body of ``--cold-batch``: one full-width batch through the entry
    point in this fresh process; prints its seconds as JSON. The clock
    starts after ``import torch`` and the weights are made, before the
    process first touches the card, so it includes the CUDA context."""
    cfg = flagship_config(steps=STEPS)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    t0 = time.perf_counter()
    out = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, out_dir, 0, BATCH, BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if out.shape != (BATCH, 3000, 1) or not np.isfinite(out).all():
        raise AssertionError(f"cold batch output {out.shape}")
    print(json.dumps({"cold_seconds": seconds}), flush=True)


def phase_cold(tmp: Path) -> dict:
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--cold-batch",
                           str(tmp / "cold")], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cold batch failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    seconds = json.loads(proc.stdout.strip().splitlines()[-1])["cold_seconds"]
    say("cold", seconds=f"{seconds:.3f}", windows_per_s=f"{BATCH / seconds:.3f}")
    return dict(seconds=seconds, windows_per_s=BATCH / seconds)


def write_split(tmp: Path, name: str, n_train: int, n_valid: int, seed: int):
    """A synthetic npy tree of n_train + n_valid recordings (35 s each)
    and its two split CSVs; returns the two datasets."""
    rows = write_synthetic_npy_tree(tmp / name, n_subjects=(n_train + n_valid + 1) // 2,
                                    duration_s=35.0, seed=seed)
    write_ids_csv(tmp / f"{name}_train.csv", rows[:n_train])
    write_ids_csv(tmp / f"{name}_valid.csv", rows[n_train:n_train + n_valid])
    return (load_split(tmp / f"{name}_train.csv", tmp / name),
            load_split(tmp / f"{name}_valid.csv", tmp / name))


def phase_tiny_train(tmp: Path) -> dict:
    """Two Adam steps at tiny widths, fp32, on the card (K1, K3) and on the
    CPU (plain versions) from the same weights, batch, t, noise and encoder
    eps; loss and parameters held at the model bound. Then one train_ldm
    run on the card that reaches an eval, the DDPM sample and a checkpoint."""
    cfg = tiny_config(steps=4)
    unet_sd, ae_sd = seeded_weights(cfg, SEED + 20)
    rng = np.random.default_rng(SEED)
    b, lat = 4, (1, 64)
    x = rng.uniform(size=(b, 1, 4 * lat[1])).astype(np.float32)
    draws = [(rng.integers(0, 1000, b), rng.standard_normal((b, *lat)).astype(np.float32),
              rng.standard_normal((b, *lat)).astype(np.float32)) for _ in range(2)]
    runs = {}
    for dev in ("cuda", "cpu"):
        profiling.reset()
        with torch.device(dev):
            unet = load_numpy_state(build_unet(cfg, 1, 1), unet_sd)
            ae = load_numpy_state(build_aekl(cfg), ae_sd).requires_grad_(False)
        opt = torch.optim.Adam(unet.parameters(), lr=1e-4)
        step = T.make_ldm_train_step(unet, ae, T.make_schedule(cfg, dev), opt, 1.1)
        losses = [float(step(torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev),
                             torch.from_numpy(n).to(dev), torch.from_numpy(e).to(dev)))
                  for t, n, e in draws]
        runs[dev] = (losses, {k: v.detach().cpu().numpy() for k, v in unet.state_dict().items()},
                     read_counts())
    (card_loss, card_p, counts), (cpu_loss, cpu_p, _) = runs["cuda"], runs["cpu"]
    if counts["K3"] == 0 or counts["K2"]:
        raise AssertionError(f"tiny trainer on the card: launches {counts}")
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=2e-3, atol=2e-4,
                               err_msg="tiny trainer loss: card vs CPU")
    for k in cpu_p:
        np.testing.assert_allclose(card_p[k], cpu_p[k], rtol=2e-3, atol=2e-4,
                                   err_msg=f"tiny trainer {k}: card vs CPU")
    param_err = max(float(np.abs(card_p[k] - cpu_p[k]).max()) for k in cpu_p)
    say("tiny-train", losses=[f"{v:.5f}" for v in card_loss],
        loss_err=f"{max(abs(a - c) for a, c in zip(card_loss, cpu_loss)):.3e}",
        param_max_abs_err=f"{param_err:.3e}", k1_launches=counts["K1"],
        k3_launches=counts["K3"])

    cfg.train.n_epochs, cfg.train.batch_size, cfg.train.val_interval = 2, 4, 1
    cfg.train.output_dir = str(tmp / "tiny_train")
    train_ds, valid_ds = write_split(tmp, "tiny_npy", 6, 2, SEED)
    t0 = time.perf_counter()
    result = T.train_ldm(cfg, train_ds, valid_ds, ae_sd, device="cuda")
    seconds = time.perf_counter() - t0
    run = Path(result.run_dir)
    sample = np.load(run / "sample_unconditioned_1.npy")
    missing = [n for n in ("best_model/params.npz", "final_model/scale_factor.txt",
                           "checkpoints/step_00000004.pt") if not (run / n).exists()]
    if missing or sample.shape != (1, 1, 3072) or not np.isfinite(sample).all():
        raise AssertionError(f"tiny train_ldm run: missing {missing}, sample {sample.shape}")
    say("tiny-train", run="train_ldm", seconds=f"{seconds:.2f}",
        best_loss=f"{result.best_loss:.5f}", sample_std=f"{sample.std():.4f}")
    return dict(losses=card_loss, cpu_losses=cpu_loss, param_max_abs_err=param_err,
                train_ldm_seconds=seconds)


def phase_train_full(tmp: Path) -> dict:
    """``train_ldm`` through the entry point at ldm.yaml's width, batch
    1024, bf16, on a synthetic npy tree: one step per epoch, eval first
    only. Counts set to 0 before and read after the call; each epoch's
    seconds (one step, its windows' gather and copy included) come from
    metrics_train.jsonl."""
    cfg = flagship_config(steps=STEPS)
    cfg.train.n_epochs, cfg.train.val_interval = TRAIN_EPOCHS, 10 * TRAIN_EPOCHS
    cfg.train.output_dir = str(tmp / "train_full")
    _, ae_sd = seeded_weights(cfg, SEED)
    train_ds, valid_ds = write_split(tmp, "npy", TRAIN_BATCH, VALID_WINDOWS, SEED + 1)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    t0 = time.perf_counter()
    result = T.train_ldm(cfg, train_ds, valid_ds, ae_sd, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, forms = read_counts(), read_forms()
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_launches(cfg, steps=TRAIN_EPOCHS, eval_batches=1, encodes=1)
    log = [json.loads(line) for line in
           (Path(result.run_dir) / "metrics_train.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in log]
    ms = [r["seconds"] * 1e3 for r in log[1:]]
    if counts != want:
        raise AssertionError(f"train_ldm launches {counts}, expected {want}")
    if len(log) != TRAIN_EPOCHS or not np.isfinite(losses).all() or result.stopped_on_nan:
        raise AssertionError(f"train_ldm losses {losses}")
    median = statistics.median(ms)
    out = dict(batch=TRAIN_BATCH, losses=losses, step_ms=ms, median_step_ms=median,
               windows_per_s=TRAIN_BATCH / median * 1e3, peak_bytes=peak, wall_s=wall,
               launches=counts, forms=forms, scale_factor=result.scale_factor,
               loss_falls=losses[-1] < losses[0])
    say("train", batch=TRAIN_BATCH, epochs=TRAIN_EPOCHS, losses=[f"{v:.4f}" for v in losses],
        loss_falls=out["loss_falls"])
    say("train", median_ms_per_step=f"{median:.2f}", min_ms=f"{min(ms):.2f}",
        max_ms=f"{max(ms):.2f}", windows_per_s=f"{out['windows_per_s']:.2f}",
        peak_gib=f"{peak / 2**30:.2f}", wall_s=f"{wall:.1f}", **counts, **forms)
    free_card()
    return out


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that later in-place updates do not reach (on
    the CPU, ``.numpy()`` alone shares the tensor's storage)."""
    return t.detach().cpu().numpy().copy()


def stage1_state(ae, disc) -> dict:
    return {**{f"ae.{k}": host_copy(v) for k, v in ae.state_dict().items()},
            **{f"disc.{k}": host_copy(v) for k, v in disc.state_dict().items()}}


def tiny_stage1_run(cfg: Config, dev: str, x: np.ndarray, eps: list,
                    ae_state: dict | None = None) -> dict:
    """Steps of the stage-1 trainer on ``dev`` from ``build_trainer``'s
    weights (the AEKL's ``ae_state`` instead, when given), one per eps:
    each step's metrics and gradients (the AEKL's from the G loss, the
    discriminator's from the D loss), and the state (parameters and
    BatchNorm buffers) before and after."""
    ae, disc, opt_g, opt_d = A.build_trainer(cfg, dev)
    if ae_state is not None:
        load_numpy_state(ae, ae_state)
    named = [*((f"ae.{k}", p) for k, p in ae.named_parameters()),
             *((f"disc.{k}", p) for k, p in disc.named_parameters())]
    before = stage1_state(ae, disc)
    step = A.make_train_step(ae, disc, opt_g, opt_d, cfg)
    metrics, grads = [], []
    for e in eps:
        m = step(torch.from_numpy(x).to(dev), torch.from_numpy(e).to(dev))
        metrics.append({k: float(v) for k, v in m.items()})
        missing = [k for k, p in named if p.grad is None]
        if missing:
            raise AssertionError(f"tiny stage-1 step on {dev}: no gradient for {missing}")
        grads.append({k: host_copy(p.grad) for k, p in named})
    return dict(metrics=metrics, grads=grads, before=before, after=stage1_state(ae, disc))


def hold_tiny_stage1(got: dict, want: dict, metrics=A.METRICS,
                     what: str = "tiny stage-1 trainer") -> dict:
    """Hold one ``tiny_stage1_run`` (``got``) to another (``want``), from
    the same weights, batch and eps; raise listing every disagreement.

    - metrics of every step at the model bound (rtol 2e-3 / atol 2e-4);
    - gradients of every step, each leaf within 2e-3 of its largest |g|
      (a wrong backward shows here, whatever Adam makes of it);
    - what the steps changed, new - old, of every parameter and BatchNorm
      buffer, within 1e-2 of the leaf's largest change, which must not be
      0. Adam's update is about lr * sign(g): parameter entries whose
      gradient in any step is below 1e-3 of its leaf's largest are left
      out, as their sign is a rounding's. A step whose update was left
      out differs by 1.0 of the largest change; a flipped sign by 2.0.

    Returns the worst ratios and the entries left out."""
    faults = []
    for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in metrics:
            if not abs(gm[k] - wm[k]) <= 2e-4 + 2e-3 * abs(wm[k]):
                faults.append(f"step {i} {k}: {gm[k]:.6g}, expected {wm[k]:.6g}")
    grad_ratio = 0.0
    for i, (gg, wg) in enumerate(zip(got["grads"], want["grads"])):
        for k, w in wg.items():
            top, err = float(np.abs(w).max()), float(np.abs(gg[k] - w).max())
            if not (top > 0 and err <= 2e-3 * top):
                faults.append(f"step {i} gradient {k}: |err| {err:.3e}, "
                              f"leaf's largest |g| {top:.3e}")
            grad_ratio = max(grad_ratio, err / top if top > 0 else np.inf)
    update_ratio, left_out, entries = 0.0, 0, 0
    for k, old in want["before"].items():
        change, mine = want["after"][k] - old, got["after"][k] - old
        keep = np.ones(old.shape, bool)
        if k in want["grads"][0]:
            for g in want["grads"]:
                keep &= np.abs(g[k]) >= 1e-3 * np.abs(g[k]).max()
            left_out, entries = left_out + int((~keep).sum()), entries + keep.size
        top = float(np.abs(change).max())
        err = float(np.abs(mine - change)[keep].max(initial=0.0))
        if not (top > 0 and err <= 1e-2 * top):
            faults.append(f"change of {k}: |err| {err:.3e}, leaf's largest change {top:.3e}")
        update_ratio = max(update_ratio, err / top if top > 0 else np.inf)
    if faults:
        raise AssertionError(f"{what}, {len(faults)} disagreements:\n"
                             + "\n".join(faults))
    return dict(grad_err_ratio=grad_ratio, update_err_ratio=update_ratio, left_out=left_out,
                entries=entries)


def phase_tiny_stage1(tmp: Path) -> dict:
    """Two stage-1 steps at tiny widths, fp32, on the card (K1, K3) and on
    the CPU (plain versions) from the same weights, batch and eps, held by
    ``hold_tiny_stage1``: metrics, gradients, and what the steps changed.
    Then one train_aekl run on the card that reaches an eval, a checkpoint
    and best_model/, and one train_ldm run on the card whose frozen AEKL
    is that best_model/."""
    cfg = tiny_stage1_config()
    rng = np.random.default_rng(SEED + 30)
    b, length = 4, 256
    x = rng.uniform(size=(b, 1, length)).astype(np.float32)
    eps = [rng.standard_normal((b, 1, length // 4)).astype(np.float32) for _ in range(2)]
    profiling.reset()
    card = tiny_stage1_run(cfg, "cuda", x, eps)
    counts = read_counts()
    want = expected_stage1_launches(cfg, steps=2, eval_batches=0)
    if counts != want:
        raise AssertionError(f"tiny stage-1 trainer on the card: launches {counts}, "
                             f"expected {want}")
    cpu = tiny_stage1_run(cfg, "cpu", x, eps)
    held = hold_tiny_stage1(card, cpu)
    metric_err = max(abs(cm[k] - pm[k]) for cm, pm in zip(card["metrics"], cpu["metrics"])
                     for k in A.METRICS)
    say("tiny-stage1", g_losses=[f"{m['g_loss']:.5f}" for m in card["metrics"]],
        metric_max_abs_err=f"{metric_err:.3e}", grad_err_ratio=f"{held['grad_err_ratio']:.3e}",
        update_err_ratio=f"{held['update_err_ratio']:.3e}",
        left_out=f"{held['left_out']}/{held['entries']}", k1_launches=counts["K1"],
        k3_launches=counts["K3"])

    cfg.train.n_epochs, cfg.train.batch_size, cfg.train.val_interval = 2, 4, 1
    cfg.train.output_dir = str(tmp / "tiny_stage1")
    train_ds, valid_ds = write_split(tmp, "tiny_stage1_npy", 6, 2, SEED + 4)
    t0 = time.perf_counter()
    result = A.train_aekl(cfg, train_ds, valid_ds, device="cuda")
    aekl_seconds = time.perf_counter() - t0
    best = Path(result.run_dir) / "best_model"
    missing = [n for n in ("best_model/params.npz", "best_model/config.yaml",
                           "final_model/params.npz", "checkpoints/step_00000004.pt")
               if not (Path(result.run_dir) / n).exists()]
    if missing or result.stopped_on_nan or not np.isfinite(result.best_loss):
        raise AssertionError(f"tiny train_aekl run: missing {missing}, best {result.best_loss}")
    ldm_cfg = tiny_config(steps=4)
    ldm_cfg.train.n_epochs, ldm_cfg.train.batch_size, ldm_cfg.train.val_interval = 1, 4, 1
    ldm_cfg.train.output_dir = str(tmp / "tiny_stage1_ldm")
    t0 = time.perf_counter()
    ldm = T.train_ldm(ldm_cfg, train_ds, valid_ds,
                      aekl_state_from_jax(load_params_npz(best / "params.npz")),
                      aekl_cfg=Config.from_yaml(best / "config.yaml"), device="cuda")
    ldm_seconds = time.perf_counter() - t0
    if not (Path(ldm.run_dir) / "best_model" / "params.npz").exists() or not np.isfinite(
            ldm.best_loss):
        raise AssertionError(f"tiny train_ldm on the port's AEKL: best {ldm.best_loss}")
    say("tiny-stage1", run="train_aekl -> train_ldm", aekl_seconds=f"{aekl_seconds:.2f}",
        aekl_best_loss=f"{result.best_loss:.5f}", ldm_seconds=f"{ldm_seconds:.2f}",
        ldm_best_loss=f"{ldm.best_loss:.5f}", scale_factor=f"{ldm.scale_factor:.4f}")
    return dict(metrics=card["metrics"], cpu_metrics=cpu["metrics"], metric_max_abs_err=metric_err,
                **held, train_aekl_seconds=aekl_seconds, train_ldm_seconds=ldm_seconds,
                aekl_run_dir=result.run_dir)


def phase_stage1_full(tmp: Path) -> dict:
    """``train_aekl`` through the entry point at aekl_eeg.yaml (batch 2048,
    bf16) on a synthetic npy tree of 2048 training and 64 validation
    recordings: one step per epoch, one eval after the last. Counts set to
    0 before and read after the call; each epoch's seconds (one step, its
    windows' gather and copy included) come from metrics_train.jsonl."""
    cfg = stage1_config()
    cfg.train.n_epochs = cfg.train.val_interval = TRAIN_EPOCHS
    cfg.train.output_dir = str(tmp / "stage1_full")
    train_ds, valid_ds = write_split(tmp, "stage1_npy", AEKL_BATCH, VALID_WINDOWS, SEED + 3)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    t0 = time.perf_counter()
    result = A.train_aekl(cfg, train_ds, valid_ds, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, forms = read_counts(), read_forms()
    peak = torch.cuda.max_memory_allocated()
    want = expected_stage1_launches(cfg, steps=TRAIN_EPOCHS, eval_batches=1)
    log = [json.loads(line) for line in
           (Path(result.run_dir) / "metrics_train.jsonl").read_text().splitlines()]
    ms = [r["seconds"] * 1e3 for r in log[1:]]
    if counts != want:
        raise AssertionError(f"train_aekl launches {counts}, expected {want}")
    require_forms("train_aekl", counts, forms)
    finite = all(np.isfinite(r[k]) for r in log for k in A.METRICS)
    if len(log) != TRAIN_EPOCHS or not finite or result.stopped_on_nan or not (
            Path(result.run_dir) / "best_model" / "params.npz").exists():
        raise AssertionError(f"train_aekl log {log}, best {result.best_loss}")
    median = statistics.median(ms)
    out = dict(batch=AEKL_BATCH, log=log, step_ms=ms, median_step_ms=median,
               windows_per_s=AEKL_BATCH / median * 1e3, peak_bytes=peak, wall_s=wall,
               launches=counts, forms=forms, best_loss=result.best_loss)
    say("stage1", batch=AEKL_BATCH, epochs=TRAIN_EPOCHS,
        g_losses=[f"{r['g_loss']:.4f}" for r in log],
        recons_losses=[f"{r['recons_loss']:.4f}" for r in log],
        disc_losses=[f"{r['disc_loss']:.4f}" for r in log], val_l1=f"{result.best_loss:.4f}")
    say("stage1", median_ms_per_step=f"{median:.2f}", min_ms=f"{min(ms):.2f}",
        max_ms=f"{max(ms):.2f}", windows_per_s=f"{out['windows_per_s']:.2f}",
        peak_gib=f"{peak / 2**30:.2f}", wall_s=f"{wall:.1f}", **counts, **forms)
    free_card()
    return out


def usleep_state(seed: int) -> dict:
    """Weights of the FID extractor for E1: the JAX package's initialisers
    (``lecun_normal_state``), then running means N(0, 0.1^2) and variances
    U(0.5, 1.5), so that no BatchNorm is the identity."""
    with torch.device("meta"):
        sd = lecun_normal_state(USleep(), seed)
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return sd


def hold(name: str, got, want, rtol: float, atol: float) -> float:
    """Max abs error of got (card) against want (CPU), raising past the bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=f"{name}: card vs CPU")
    return float(np.abs(got - want).max())


def phase_tiny_eval(tmp: Path) -> dict:
    """E1: the evaluation path at small sizes on the card against the CPU,
    same seeds and weights, fp32 with TF32 off in cuDNN and matmuls:
    DPM++2M (4 steps) plus decode at tiny widths; USleep's features of two
    sets of 8 windows and their Fréchet distance; MS-SSIM with both
    kernels; the three band filters."""
    errs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            cfg = tiny_config(steps=4)
            cfg.diffusion.sampler = "dpm++2m"
            unet_sd, ae_sd = seeded_weights(cfg, SEED + 40)
            kw = dict(start_seed=0, stop_seed=4, batch_size=4, compute_psd=False)
            profiling.reset()
            card = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "e1_card", device="cuda", **kw)
            counts = read_counts()
            cpu = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "e1_cpu", device="cpu", **kw)
            want = expected_launches(cfg, unet_forwards=4, decodes=1)
            if counts != {**want, "K3": 0}:
                raise AssertionError(f"tiny DPM++2M sampler launches {counts}, expected {want}")
            errs["dpm"] = hold("DPM++2M-4 + decode", card, cpu, 2e-3, 2e-4)

            rng = np.random.default_rng(SEED + 41)
            sets = rng.uniform(size=(2, 8, 1, 3000)).astype(np.float32)
            sd = usleep_state(SEED + 42)
            feats = {}
            for dev in ("cuda", "cpu"):
                usleep = load_numpy_state(USleep(), sd)
                feats[dev] = [usleep_fid_features(usleep, w, 8, dev) for w in sets]
            errs["usleep"] = hold("USleep features", feats["cuda"], feats["cpu"], 2e-3, 2e-4)
            fids = {dev: frechet_distance(*f) for dev, f in feats.items()}
            errs["fid"] = hold("Frechet distance", fids["cuda"], fids["cpu"], 1e-3, 0.0)

            x = torch.from_numpy(sets[0])
            y = torch.from_numpy(np.clip(sets[0] + 0.1 * rng.standard_normal(sets[0].shape),
                                         0, 1).astype(np.float32))
            for kernel_type, k in (("gaussian", 7), ("uniform", 16)):
                got = ms_ssim_1d(x.cuda(), y.cuda(), kernel_size=k, kernel_type=kernel_type)
                ref = ms_ssim_1d(x, y, kernel_size=k, kernel_type=kernel_type)
                errs[f"ms_ssim_{kernel_type}"] = hold(f"ms_ssim_1d {kernel_type} k {k}",
                                                      got.cpu(), ref, 1e-4, 1e-5)
            for band in EEG_BANDS:
                errs[f"band_{band}"] = hold(f"filter_band {band}", filter_band(x.cuda(), band).cpu(),
                                            filter_band(x, band), 1e-4, 1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    say("tiny-eval", fid_card=f"{fids['cuda']:.6f}", fid_cpu=f"{fids['cpu']:.6f}",
        k1_launches=counts["K1"], k2_launches=counts["K2"],
        **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()})
    free_card()
    return dict(max_abs_err=errs, fid_card=fids["cuda"], fid_cpu=fids["cpu"], launches=counts)


def run_cli(*argv) -> float:
    """``python -m sleepgen_torch <argv>`` in this process (so its kernel
    launches are counted here): the umbrella's ``main`` with ``sys.argv``
    set, then restored."""
    saved = sys.argv
    sys.argv = ["sleepgen_torch", *argv]
    try:
        return sleepgen_torch_main()
    finally:
        sys.argv = saved


def read_tsv(path: Path) -> tuple:
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh, delimiter="\t"))
    return rows[0], np.array([float(r[1]) for r in rows[1:]])


def timed(fn, *args):
    """(result, seconds on the host clock) of fn(*args), the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_eval_full(tmp: Path) -> dict:
    """E2: the evaluation at full width on a synthetic test split of 1024
    recordings of 35 s. DPM++2M-20 sampling through ``sample_ldm_trials``
    at the flagship configuration (batch 64, bf16, seeded weights): a
    warm-up batch, three timed batches with their launch counts, then
    seeds 0-1023 as artifacts; ``compute-fid`` on them and the floor;
    ``compute-mmds`` in both modes on a seeded full-width AEKL run dir."""
    cfg = flagship_config(steps=DPM_STEPS)
    cfg.diffusion.sampler = "dpm++2m"
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    npy, ids = tmp / "eval_npy", tmp / "eval_test.csv"
    write_ids_csv(ids, write_synthetic_npy_tree(npy, n_subjects=EVAL_WINDOWS // 2,
                                                duration_s=35.0, seed=SEED + 5))
    want = {**expected_launches(cfg, unet_forwards=DPM_STEPS, decodes=1), "K3": 0}
    batches = EVAL_WINDOWS // BATCH
    sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "dpm_warmup", 0, BATCH, BATCH)
    seconds = []
    for i in range(TIMED_BATCHES):
        profiling.reset()
        out, sec = timed(sample_ldm_trials, cfg, unet_sd, ae_sd, 1.0, tmp / "dpm_timed",
                         i * BATCH, (i + 1) * BATCH, BATCH)
        seconds.append(sec)
        launches, shapes = read_counts(), read_shapes()
        if out.shape != (BATCH, 3000, 1) or not np.isfinite(out).all():
            raise AssertionError(f"DPM++2M batch {i}: output {out.shape}")
        if launches != want:
            raise AssertionError(f"DPM++2M batch {i}: launches {launches}, expected {want}")
        say("dpm", batch=i, seconds=f"{sec:.3f}", k1_launches=launches["K1"],
            k2_launches=launches["K2"], out_std=f"{out.std():.4f}")
    median = statistics.median(seconds)
    say("dpm", steps=DPM_STEPS, batches=TIMED_BATCHES, median_seconds=f"{median:.3f}",
        min_seconds=f"{min(seconds):.3f}", max_seconds=f"{max(seconds):.3f}",
        windows_per_s=f"{BATCH / median:.3f}",
        windows_per_s_min_max=f"{BATCH / max(seconds):.3f}-{BATCH / min(seconds):.3f}")
    samples = tmp / "dpm_samples"
    profiling.reset()
    _, all_seconds = timed(sample_ldm_trials, cfg, unet_sd, ae_sd, 1.0, samples, 0,
                           EVAL_WINDOWS, BATCH)
    if read_counts() != {k: v * batches for k, v in want.items()} or len(
            list(samples.glob("sample_*.npy"))) != EVAL_WINDOWS:
        raise AssertionError(f"DPM++2M seeds 0-{EVAL_WINDOWS - 1}: launches {read_counts()}")
    say("dpm", seeds=EVAL_WINDOWS, seconds=f"{all_seconds:.3f}",
        windows_per_s=f"{EVAL_WINDOWS / all_seconds:.3f}")

    data = ["--path_test_ids", str(ids), "--path_pre_processed", str(npy)]
    fid, fid_s = timed(run_cli, "compute-fid", *data, "--sample_dir", str(samples))
    floor, floor_s = timed(run_cli, "compute-fid", *data)
    if not all(np.isfinite(v) and v >= -1e-6 for v in (fid, floor)):
        raise AssertionError(f"compute-fid: FID {fid}, floor {floor}")
    usleep = load_usleep(seed=2)
    windows = to_bcl(center_crop_valid(load_split(ids, npy).epoch_windows(
        np.random.default_rng(2))))
    usleep_fid_features(usleep, windows, 256, "cuda")
    feat_s = [timed(usleep_fid_features, usleep, windows, 256, "cuda")[1] for _ in range(3)]
    features_per_s = EVAL_WINDOWS / statistics.median(feat_s)
    say("fid", fid=f"{fid:.6f}", floor=f"{floor:.6f}", cli_seconds=f"{fid_s:.3f}",
        floor_cli_seconds=f"{floor_s:.3f}", features_per_s=f"{features_per_s:.1f}",
        features_s_min_max=f"{min(feat_s):.4f}-{max(feat_s):.4f}")
    del usleep

    run = tmp / "eval_aekl"
    run.mkdir()
    cfg.to_yaml(run / "config.yaml")
    save_params_npz(run / "params.npz", {"params": aekl_state_to_jax(ae_sd)})
    out = tmp / "eval_mmds"
    profiling.reset()
    recon_mean, recon_s = timed(run_cli, "compute-mmds", "--best_model_path", str(run), *data,
                                "--output_dir", str(out), "--batch_size", str(BATCH))
    counts = read_counts()
    if counts != recon_launches(cfg, batches=batches):
        raise AssertionError(f"compute-mmds reconstruction: launches {counts}")
    pairs_mean, pairs_s = timed(run_cli, "compute-mmds", "--best_model_path", str(run), *data,
                                "--output_dir", str(out), "--mode", "test_pairs")
    for name, rows in ((f"ms_ssim_reconstruction_edfx_no-spectral_{cfg.aekl.latent_channels}.tsv",
                        EVAL_WINDOWS), ("ms_ssim_test_pairs_edfx.tsv", EVAL_WINDOWS - 1)):
        header, scores = read_tsv(out / name)
        if len(scores) != rows or not np.isfinite(scores).all():
            raise AssertionError(f"{name}: {len(scores)} rows, expected {rows}, header {header}")
    ae = eval_aekl(cfg, ae_sd)
    windows = load_split(ids, npy).epoch_windows(np.random.default_rng(cfg.train.seed))
    recon_s_all = [timed(reconstruction_scores, ae, windows, BATCH, torch.device("cuda"))[1]
                   for _ in range(3)]
    recon_per_s = EVAL_WINDOWS / statistics.median(recon_s_all)
    say("mmds", reconstruction_mean=f"{recon_mean:.6f}", pairs_mean=f"{pairs_mean:.6f}",
        k1_launches_per_batch=counts["K1"] // batches,
        cli_seconds=f"{recon_s:.3f}", pairs_cli_seconds=f"{pairs_s:.3f}",
        windows_per_s=f"{recon_per_s:.1f}",
        seconds_min_max=f"{min(recon_s_all):.4f}-{max(recon_s_all):.4f}")
    del ae
    free_card()
    return dict(dpm=dict(steps=DPM_STEPS, seconds=seconds, median_seconds=median,
                         windows_per_s=BATCH / median, launches=launches, shapes=shapes,
                         all_seconds=all_seconds),
                fid=dict(fid=fid, floor=floor, cli_seconds=fid_s, floor_cli_seconds=floor_s,
                         feature_seconds=feat_s, features_per_s=features_per_s),
                mmds=dict(reconstruction_mean=recon_mean, pairs_mean=pairs_mean,
                          cli_seconds=recon_s, pairs_cli_seconds=pairs_s,
                          launches=counts, seconds=recon_s_all, windows_per_s=recon_per_s))


def serve_config(cfg: Config) -> Config:
    """``cfg`` made a conditional checkpoint of the sleep stages, sampled
    with DPM++2M-20."""
    cfg.unet.num_classes = SERVE_CLASSES
    cfg.diffusion.sampler = "dpm++2m"
    cfg.diffusion.num_inference_steps = DPM_STEPS
    return cfg


def write_run_dirs(root: Path, cfg: Config, unet_sd, ae_sd, scale_factor: float) -> tuple:
    """Port run dirs of the AEKL and the LDM, as ``serve`` and ``sample``
    read them: config.yaml, params.npz, and the LDM's scale_factor.txt."""
    for name, tree in (("aekl", aekl_state_to_jax(ae_sd)), ("ldm", unet_state_to_jax(unet_sd))):
        (root / name).mkdir(parents=True)
        cfg.to_yaml(root / name / "config.yaml")
        save_params_npz(root / name / "params.npz", {"params": tree})
    (root / "ldm" / "scale_factor.txt").write_text(repr(scale_factor))
    return root / "aekl", root / "ldm"


def phase_tiny_serve(tmp: Path) -> dict:
    """S1: ``SamplerService`` over port run dirs of a tiny conditional
    checkpoint (UNet mc 32, [1, 2], attention [2], G 8, 5 classes, latent
    64; AEKL [2, 2, 4]; fp32, TF32 off; seeded weights, so the label
    embedding and the output convolution are non-zero), on the card
    against the same service on the CPU: DPM++2M-4 at batch 4, stage 2
    plain and guided at 2.0, held at the model bound (rtol 2e-3 / atol
    2e-4). The guided request's launches equal the plain one's, as derived
    from the configuration (one forward of 2B per step); the sampler cache
    holds (4, False) and (4, True) after scales 2.0 and 3.0; each
    validation error raises with no kernel launched."""
    cfg = serve_config(tiny_config(steps=4))
    cfg.aekl.num_channels = [2, 2, 4]
    cfg.diffusion.num_inference_steps = 4
    unet_sd, ae_sd = seeded_weights(cfg, SEED + 50)
    dirs = write_run_dirs(tmp / "tiny_serve", cfg, unet_sd, ae_sd, 1.3)
    card, cpu = (SamplerService.from_run_dirs(*dirs, batch_size=4, device=dev)
                 for dev in ("cuda", "cpu"))
    want = {**expected_launches(cfg, unet_forwards=4, decodes=1), "K3": 0}
    errs, counts, outs = {}, {}, {}
    for name, kw in (("plain", dict(stage=SERVE_STAGE)),
                     ("guided", dict(stage=SERVE_STAGE, guidance_scale=SERVE_SCALE))):
        profiling.reset()
        outs[name] = card.sample(range(4), **kw)
        counts[name] = read_counts()
        if counts[name] != want:
            raise AssertionError(f"S1 {name} request: launches {counts[name]}, expected {want}")
        want_out = cpu.sample(range(4), **kw)
        np.testing.assert_allclose(outs[name], want_out, rtol=2e-3, atol=2e-4,
                                   err_msg=f"S1 {name} request: card vs CPU")
        errs[name] = float(np.abs(outs[name] - want_out).max())
    if np.allclose(outs["plain"], outs["guided"]):
        raise AssertionError("S1: the guided request equals the plain one")
    card.sample(range(4), stage=SERVE_STAGE, guidance_scale=3.0)
    if set(card._samplers) != {(4, False), (4, True)}:
        raise AssertionError(f"S1: sampler cache {sorted(card._samplers)}")
    for bad in (dict(), dict(stage=-1), dict(stage=SERVE_CLASSES),
                dict(stage=SERVE_STAGE, guidance_scale="strong")):
        profiling.reset()
        try:
            card.sample_async(range(4), **bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"S1: request {bad} did not raise")
        if any(read_counts().values()):
            raise AssertionError(f"S1: request {bad} launched {read_counts()}")
    say("tiny-serve", plain_max_abs_err=f"{errs['plain']:.3e}",
        guided_max_abs_err=f"{errs['guided']:.3e}", k1_launches=counts["guided"]["K1"],
        k2_launches=counts["guided"]["K2"], cache=sorted(card._samplers))
    del card, cpu
    free_card()
    return dict(max_abs_err=errs, launches=counts)


def timed_request(svc: SamplerService, seeds, **kw) -> dict:
    """One request on the host clock, the card synchronised before: the
    seconds ``sample_async`` took to return and to the end of
    ``result()``, whether the card was still busy at that return, and the
    request's launch counts, shapes and K2 weight re-layouts."""
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = svc.sample_async(seeds, **kw)
    queued = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    out = pending.result()
    seconds = time.perf_counter() - t0
    if out.shape != (len(seeds), 3000, 1) or not np.isfinite(out).all():
        raise AssertionError(f"request {kw}: output {out.shape}")
    return dict(out=out, queued_s=queued, seconds=seconds, busy_at_return=busy,
                counts=read_counts(), shapes=read_shapes(), relayouts=read_relayouts())


def spin_cycles_per_s() -> float:
    """Clock cycles per second of ``torch.cuda._sleep``'s spin kernel."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10**6)
    start.record()
    torch.cuda._sleep(10**8)
    stop.record()
    torch.cuda.synchronize()
    return 10**8 / (start.elapsed_time(stop) / 1e3)


def queue_behind_spin(svc: SamplerService, spin_s: float, seeds, **kw) -> dict:
    """``sample_async`` with ``spin_s`` seconds of a spin kernel queued on
    the card before it: the seconds it took to return, whether the card
    was still spinning then, and the seconds to the end of ``result()``.
    A call that waits for the card returns after the spin; so does one
    whose kernels overflow the card's queue of pending launches."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_s * spin_cycles_per_s()))
    t0 = time.perf_counter()
    pending = svc.sample_async(seeds, **kw)
    queued = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    pending.result()
    return dict(spin_s=spin_s, queued_s=queued, busy_at_return=busy,
                seconds=time.perf_counter() - t0)


def queue_without_sync(svc: SamplerService, seeds, **kw) -> None:
    """``sample_async`` under torch's sync debug mode "error": any PyTorch
    call in it that waits for the card (a copy from pageable memory, a
    value read back) raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = svc.sample_async(seeds, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pending.result()


def phase_serve_full() -> dict:
    """S2: ``SamplerService`` at the flagship configuration made a
    conditional checkpoint of the 5 sleep stages (``serve_config``),
    DPM++2M-20, bf16, batch 64, seeded weights: ``warmup()``'s seconds;
    three rounds of a plain request of 64 seeds (stage 2), a guided one
    (stage 2, scale 2.0) and one of seed 5 alone, each with its launches as
    derived from the configuration (a guided request runs one forward of
    128 per step, so the plain counts) and no K2 weight re-layout; seed 5
    alone against seed 5 in the batch within ``ALONE_BOUND``; a plain and
    a guided request queued without a sync (``queue_without_sync``, and a
    one-step request behind ``SPIN_S`` of card work); then one plain and
    one guided request under torch.profiler. Returns the guided request's
    kernel shapes and counts for the kernel rows."""
    cfg = serve_config(flagship_config(steps=DPM_STEPS))
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    svc = SamplerService(cfg, cfg, unet_sd, ae_sd, 1.0, batch_size=BATCH, device="cuda")
    warmup_s = svc.warmup()
    say("serve", warmup_s=f"{warmup_s:.3f}", cache=sorted(svc._samplers))
    want = {**expected_launches(cfg, unet_forwards=DPM_STEPS, decodes=1), "K3": 0}
    requests = {"plain": (range(BATCH), dict(stage=SERVE_STAGE)),
                "guided": (range(BATCH), dict(stage=SERVE_STAGE, guidance_scale=SERVE_SCALE)),
                "alone": ([SEED_ALONE], dict(stage=SERVE_STAGE))}
    runs = {name: [] for name in requests}
    for i in range(TIMED_BATCHES):
        for name, (seeds, kw) in requests.items():
            r = timed_request(svc, seeds, **kw)
            if r["counts"] != want or r["relayouts"]:
                raise AssertionError(f"S2 {name} request {i}: launches {r['counts']}, expected "
                                     f"{want}; K2 weight re-layouts {r['relayouts']}")
            runs[name].append(r)
            say("serve", request=name, round=i, seconds=f"{r['seconds']:.4f}",
                async_return_s=f"{r['queued_s']:.4f}", busy_at_return=r["busy_at_return"],
                k1_launches=r["counts"]["K1"], k2_launches=r["counts"]["K2"],
                relayouts=r["relayouts"])
    batch_out = runs["plain"][0]["out"]
    alone_err = float(np.abs(runs["alone"][0]["out"][0] - batch_out[SEED_ALONE]).max())
    bound = ALONE_BOUND * float(np.abs(batch_out).max())
    if not alone_err <= bound:
        raise AssertionError(f"S2: seed {SEED_ALONE} alone differs from its place in the batch "
                             f"by {alone_err}, bound {bound}")
    guided_diff = float(np.abs(runs["guided"][0]["out"] - batch_out).max())
    if guided_diff == 0.0:
        raise AssertionError("S2: the guided request equals the plain one")
    summary = {}
    for name, rs in runs.items():
        sec = [r["seconds"] for r in rs]
        n = len(requests[name][0])
        summary[name] = dict(windows=n, seconds=sec, median_seconds=statistics.median(sec),
                             windows_per_s=n / statistics.median(sec),
                             async_return_s=[r["queued_s"] for r in rs],
                             busy_at_return=[r["busy_at_return"] for r in rs])
        say("serve", request=name, windows=n, median_s=f"{statistics.median(sec):.4f}",
            min_max_s=f"{min(sec):.4f}-{max(sec):.4f}",
            windows_per_s=f"{n / statistics.median(sec):.3f}",
            async_return_median_s=f"{statistics.median(summary[name]['async_return_s']):.4f}")
    # sample_async queues without waiting: no PyTorch call in it waits for
    # the card, and a one-step request (fewer launches than the card's
    # queue holds) returns while 1.5 s of card work is still ahead of it
    one_step = serve_config(flagship_config(steps=1))
    one_step.diffusion.num_inference_steps = 1
    svc1 = SamplerService(one_step, one_step, unet_sd, ae_sd, 1.0, batch_size=BATCH,
                          device="cuda")
    svc1.warmup()
    behind_spin = {}
    for name in ("plain", "guided"):
        seeds, kw = requests[name]
        queue_without_sync(svc, seeds, **kw)
        short = queue_behind_spin(svc1, SPIN_S, seeds, **kw)
        if not (short["busy_at_return"] and short["queued_s"] < SPIN_S):
            raise AssertionError(f"S2 one-step {name} request: sample_async returned after "
                                 f"{short['queued_s']:.3f} s behind a {SPIN_S} s spin, card "
                                 f"busy {short['busy_at_return']}: it waited for the card")
        full = queue_behind_spin(svc, SPIN_S, seeds, **kw)
        behind_spin[name] = dict(one_step=short, steps_20=full)
        say("serve-async", request=name, sync_debug="no sync", spin_s=SPIN_S,
            one_step_return_s=f"{short['queued_s']:.4f}",
            steps_20_return_s=f"{full['queued_s']:.4f}",
            steps_20_busy_at_return=full["busy_at_return"])
    del svc1
    profiles = {}
    for name in ("plain", "guided"):
        seeds, kw = requests[name]
        wall_ms, device_ms, top, n_kernels = device_profile(lambda: svc.sample(seeds, **kw), 1)
        profiles[name] = dict(wall_ms=wall_ms, device_ms=device_ms,
                              busy_share=device_ms / wall_ms, top=top)
        say("serve-profile", request=name, wall_ms=f"{wall_ms:.2f}",
            device_ms=f"{device_ms:.2f}", busy_share=f"{device_ms / wall_ms:.3f}",
            kernels=n_kernels)
        for row in top[:8]:
            say("serve-profile-top", request=name, ms=f"{row['ms_per_run']:.3f}",
                kernel=row["kernel"][:80])
    say("serve", alone_max_abs_err=f"{alone_err:.3e}", alone_bound=f"{bound:.3e}",
        guided_vs_plain_max_abs=f"{guided_diff:.4f}")
    guided = runs["guided"][-1]
    del svc
    free_card()
    return dict(warmup_s=warmup_s, requests=summary, alone_max_abs_err=alone_err,
                alone_bound=bound, behind_spin=behind_spin, profiles=profiles,
                guided_counts=guided["counts"],
                guided_shapes=guided["shapes"])


SERVE_REQUESTS = [dict(start=0, stop=BATCH, stage=0), dict(start=BATCH, stop=2 * BATCH, stage=1),
                  dict(start=0, stop=BATCH),  # no stage: an error line
                  dict(start=2 * BATCH, stop=3 * BATCH, stage=3),
                  dict(start=3 * BATCH, stop=4 * BATCH, stage=4)]


def serve_cli(dirs: tuple, out: Path, *flags) -> dict:
    """``python -m sleepgen_torch serve`` in a process of its own, fed
    SERVE_REQUESTS once it printed ``ready``: the ready line's warm-up
    seconds, each response line, and the seconds from the first request
    sent to the last response, which comes after its artifact is written."""
    cmd = [sys.executable, "-m", "sleepgen_torch", "serve", "--best_model_path", str(dirs[0]),
           "--diffusion_path", str(dirs[1]), "--output_dir", str(out), "--batch_size",
           str(BATCH), *flags]
    with open(out.with_suffix(".stderr"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        watchdog = threading.Timer(300, proc.kill)
        watchdog.start()
        try:
            ready = next((line for line in proc.stdout if line.startswith("ready")), None)
            if ready is None:
                raise RuntimeError(f"serve {flags} ended before it was ready (exit "
                                   f"{proc.wait()}):\n{out.with_suffix('.stderr').read_text()}")
            t0 = time.perf_counter()
            proc.stdin.write("".join(json.dumps(r) + "\n" for r in SERVE_REQUESTS))
            proc.stdin.close()
            lines, seconds = [], float("nan")
            for line in proc.stdout:
                if line.startswith("{"):
                    lines.append(json.loads(line))
                    seconds = time.perf_counter() - t0
            code = proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if code != 0:
        raise RuntimeError(f"serve {flags} exited {code}:\n"
                           f"{out.with_suffix('.stderr').read_text()}")
    return dict(warmup_s=float(re.search(r"warm-up ([0-9.]+)s", ready).group(1)), lines=lines,
                seconds=seconds)


def phase_serve_cli(tmp: Path) -> dict:
    """S3: the serving CLIs on the card, each in a process of its own, on
    port run dirs of S2's configuration and weights: ``warm-cache
    --targets sampler,dpm --batch_sizes 64`` (its seconds, the build
    already on disk), then ``serve`` fed four requests of 64 seeds with a
    stage each and one without, in strict mode and with ``--pipeline``:
    the error line, 64 windows per answered request, the two modes'
    artifacts equal, and each mode's windows/s from the first request
    sent to the last response."""
    cfg = serve_config(flagship_config(steps=DPM_STEPS))
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    dirs = write_run_dirs(tmp / "serve_runs", cfg, unet_sd, ae_sd, 1.0)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sleepgen_torch", "warm-cache", "--config_file",
                           str(dirs[1] / "config.yaml"), "--targets", "sampler,dpm",
                           "--batch_sizes", str(BATCH)], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    warm_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"warm-cache exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    warmed = [line for line in proc.stdout.splitlines() if line.startswith("warmed")]
    say("warm-cache", seconds=f"{warm_s:.2f}", calls=len(warmed))
    for line in warmed:
        say("warm-cache", line=line.replace(" ", "_"))
    modes, windows = {}, BATCH * sum("stage" in r for r in SERVE_REQUESTS)
    for mode, flags in (("strict", ()), ("pipeline", ("--pipeline",))):
        out = tmp / f"serve_{mode}"
        run = serve_cli(dirs, out, *flags)
        answered = {r["request"]: r for r in run["lines"]}
        errors = sorted(i for i, r in answered.items() if "error" in r)
        ns = [r["n"] for i, r in sorted(answered.items()) if "n" in r]
        if errors != [2] or ns != [BATCH] * 4 or "pass stage" not in answered[2]["error"]:
            raise AssertionError(f"serve {mode}: responses {run['lines']}")
        run["windows_per_s"] = windows / run["seconds"]
        modes[mode] = run
        say("serve-cli", mode=mode, ready_warmup_s=run["warmup_s"],
            seconds=f"{run['seconds']:.3f}", windows=windows,
            windows_per_s=f"{run['windows_per_s']:.3f}")
    for i in (0, 1, 3, 4):
        a, b = (np.load(tmp / f"serve_{m}" / f"signals_{i}.npy") for m in modes)
        if a.shape != (BATCH, 3000, 1) or not np.isfinite(a).all():
            raise AssertionError(f"serve request {i}: artifact {a.shape}")
        np.testing.assert_array_equal(a, b, err_msg=f"serve request {i}: strict vs --pipeline")
    say("serve-cli", artifacts_equal=True, error_line=modes["strict"]["lines"][2]["error"][:60])
    return dict(warm_cache_s=warm_s, warmed=warmed,
                **{m: {k: v for k, v in r.items() if k != "lines"} for m, r in modes.items()})


# -- the signal-space DM (phase 3's DM steps, M1, M2) ---------------------------

def dm_config() -> Config:
    """``dm.yaml`` as it stands: UNet mc 128 / [1, 2, 4] / attention [8, 4] /
    G 32 on (B, 1, 3072) windows, batch 512, bf16."""
    cfg = Config.from_yaml(DM_CONFIG)
    got = (cfg.train.batch_size, cfg.dtype, cfg.unet.image_size, cfg.unet.norm_num_groups)
    if got != (DM_TRAIN_BATCH, "bfloat16", 3072, 32):
        raise AssertionError(f"{DM_CONFIG}: batch, dtype, length, G {got}")
    return cfg


def tiny_dm_config(num_classes: int = 0) -> Config:
    """The tiny UNet (mc 32, [1, 2], attention [2], G 8, fp32) on windows of
    4096: the first level's groups hold 16,384 elements and the skip
    concatenations' up to 49,152, so K1's and K3's cluster form runs at
    G 8."""
    cfg = tiny_config(steps=4)
    cfg.unet.image_size, cfg.unet.num_classes = 4096, num_classes
    return cfg


def dm_state(cfg: Config, seed: int) -> dict:
    with torch.device("meta"):
        return seeded_state_dict(build_unet(cfg, 1, 1), seed)


def expected_dm_launches(cfg: Config, forwards: int, train_steps: int = 0) -> dict:
    """Kernel launches of the DM, derived from the configuration: a forward
    without autograd runs the sampler's K1 and K2 (no decode); a training
    step K1 and K3 at every UNet GroupNorm and no K2."""
    per, n = expected_launches(cfg, 1, 0), gn_counts(cfg)["unet_gn"]
    return {"K1": forwards * per["K1"] + train_steps * n, "K2": forwards * per["K2"],
            "K3": train_steps * n}


def phase_dm_sample_step(tmp: Path) -> tuple:
    """One DDIM step of the full-width DM through ``sample_dm_trials`` at
    batch 64 (bf16, the 1000-entry table), with the counts set to 0 before
    and read after: they must equal those derived from the configuration."""
    cfg = dm_config()
    profiling.reset()
    out = sample_dm_trials(cfg, dm_state(cfg, SEED), tmp / "dm_warmup", 0, BATCH, BATCH,
                           DM_TABLE, 1, compute_psd=False)
    torch.cuda.synchronize()
    counts, shapes = read_counts(), read_shapes()
    require_k5("DM DDIM step", cfg, forwards=1)
    want = expected_dm_launches(cfg, forwards=1)
    if counts != want or out.shape != (BATCH, 3000, 1) or not np.isfinite(out).all():
        raise AssertionError(f"DM DDIM step: launches {counts}, expected {want}, "
                             f"output {out.shape}")
    say("dm-step", batch=BATCH, k1_launches=counts["K1"], k2_launches=counts["K2"],
        k1_shapes=len(shapes["K1"]), k2_shapes=len(shapes["K2"]), **shapes["forms"])
    free_card()
    return counts, shapes


def phase_dm_train_step() -> tuple:
    """One full-width DM training step (dm.yaml, batch 512, bf16) with the
    counts set to 0 before and read after: K1 and K3 at every UNet
    GroupNorm, as derived from the configuration, K2 none; its peak
    memory."""
    cfg = dm_config()
    unet, sched, opt = D.build_dm_trainer(cfg, "cuda")
    step = D.make_dm_train_step(unet, sched, opt, cfg.spectral, DTYPES[cfg.dtype])
    x = train_windows(DM_TRAIN_BATCH, SEED).to(DTYPES[cfg.dtype]).float()
    gen = C.make_generator(cfg.train.seed, "cuda", C.TRAIN_STREAM, 0)
    t, noise, _ = D.draw_dm_step_inputs(gen, DM_TRAIN_BATCH, (1, x.shape[-1]),
                                        sched.num_timesteps)
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    metrics = step(x, t, noise)
    torch.cuda.synchronize()
    counts, shapes = read_counts(), read_shapes()
    peak = torch.cuda.max_memory_allocated()
    want = expected_dm_launches(cfg, forwards=0, train_steps=1)
    if counts != want or not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError(f"DM training step: launches {counts}, expected {want}, "
                             f"loss {float(metrics['loss'])}")
    say("dm-train-step", batch=DM_TRAIN_BATCH, loss=f"{float(metrics['loss']):.5f}",
        k1_launches=counts["K1"], k3_launches=counts["K3"], k2_launches=counts["K2"],
        k1_shapes=len(shapes["K1"]), peak_gib=f"{peak / 2**30:.2f}", **shapes["forms"])
    del unet, opt, step, x, t, noise, metrics
    free_card()
    return counts, shapes


def tiny_dm_run(cfg: Config, dev: str, x: np.ndarray, draws: list) -> dict:
    """Steps of the DM trainer on ``dev`` from seeded weights (the
    trainer's own initialisation zeroes the output convolution, and with it
    every other gradient of a first step), one per draw (t, noise, labels,
    drop): each step's metrics and gradients, and the parameters before and
    after."""
    unet, sched, opt = D.build_dm_trainer(cfg, dev)
    load_numpy_state(unet, dm_state(cfg, SEED + 65))  # no zero-initialised layer
    before = {k: host_copy(v) for k, v in unet.state_dict().items()}
    step = D.make_dm_train_step(unet, sched, opt, cfg.spectral)
    metrics, grads = [], []
    for draw in draws:
        m = step(torch.from_numpy(x).to(dev),
                 *(None if a is None else torch.from_numpy(a).to(dev) for a in draw))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: host_copy(p.grad) for k, p in unet.named_parameters()})
    return dict(metrics=metrics, grads=grads, before=before,
                after={k: host_copy(v) for k, v in unet.state_dict().items()})


def repaint_noises(shape: tuple, steps: int, num_resample: int, seed: int) -> list:
    """Every draw of one RePaint run, made with numpy on the host."""
    rng = np.random.default_rng(seed)
    n = 1 + steps * (3 * num_resample - 1)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(n)]


def phase_tiny_dm(tmp: Path) -> dict:
    """M1: the DM path at tiny widths on the card against the CPU, same
    seeds and weights, fp32 with TF32 off: ``sample_dm_trials`` with 4 DDIM
    steps on windows of 4096 (K1's cluster form at G 8), launch counts as
    derived; two DM training steps, and one conditional step with label
    dropout and the spectral term, each held by ``hold_tiny_stage1``
    (metrics at the model bound, gradients within 2e-3 of each leaf's
    largest, what the steps changed within 1e-2); RePaint in signal space
    (``impute_dm``) and in latent space (``impute_ldm``, the tiny LDM and
    AEKL [4, 4, 8]) over an 8-step schedule with ``num_resample`` 2 on the
    same injected noise, at the model bound, the observed region equal to
    x_known bitwise on the card."""
    errs, held = {}, {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            cfg = tiny_dm_config()
            sd = dm_state(cfg, SEED + 60)
            kw = dict(start_seed=0, stop_seed=4, batch_size=4, num_train_timesteps=DM_TABLE,
                      num_ddim_steps=4, compute_psd=False)
            profiling.reset()
            card = sample_dm_trials(cfg, sd, tmp / "d1_card", device="cuda", **kw)
            counts, shapes = read_counts(), read_shapes()
            cpu = sample_dm_trials(cfg, sd, tmp / "d1_cpu", device="cpu", **kw)
            want = expected_dm_launches(cfg, forwards=4)
            cluster = shapes["forms"].get("K1_cluster", 0)
            if counts != want or not cluster:
                raise AssertionError(f"tiny DM sampler: launches {counts}, expected {want}; "
                                     f"K1 shapes {sorted(shapes['K1'])}")
            errs["sample"] = hold("DM DDIM-4", card, cpu, 2e-3, 2e-4)

            rng = np.random.default_rng(SEED + 61)
            b, length = 4, cfg.unet.image_size
            x = rng.uniform(size=(b, 1, length)).astype(np.float32)
            draws = [(rng.integers(0, 1000, b), rng.standard_normal((b, 1, length)).astype(
                np.float32), None, None) for _ in range(2)]
            runs = {dev: tiny_dm_run(cfg, dev, x, draws) for dev in ("cuda", "cpu")}
            held["train"] = hold_tiny_stage1(runs["cuda"], runs["cpu"], D.METRICS, "tiny DM")
            cond = tiny_dm_config(SERVE_CLASSES)
            cond.spectral = True
            drop = np.array([True, False, False, True])
            cond_draw = [(draws[0][0], draws[0][1], np.arange(b), drop)]
            runs = {dev: tiny_dm_run(cond, dev, x, cond_draw) for dev in ("cuda", "cpu")}
            held["conditional"] = hold_tiny_stage1(runs["cuda"], runs["cpu"], D.METRICS,
                                                   "tiny conditional DM")

            sched = {dev: NoiseSchedule.create("linear_beta", 8, cfg.diffusion.linear_start,
                                               cfg.diffusion.linear_end, device=dev)
                     for dev in ("cuda", "cpu")}
            mask = np.ones((1, 1, length), np.float32)
            mask[..., 1000:2500] = 0.0
            noises = repaint_noises((b, 1, length), 8, 2, SEED + 62)
            lcfg = tiny_config(steps=4)
            unet_sd, ae_sd = seeded_weights(lcfg, SEED + 63)
            lmask = np.ones((1, 1, 256), np.float32)
            lmask[..., 60:140] = 0.0
            lnoises = repaint_noises((b, 1, 64), 8, 2, SEED + 64)
            lx = np.ascontiguousarray(x[..., :256])
            out, repaint_counts = {}, {}
            for dev in ("cuda", "cpu"):
                profiling.reset()
                unet = build_dm(cfg, sd, torch.device(dev))
                lunet, ae = build_models(lcfg, unet_sd, ae_sd, torch.device(dev))
                with torch.inference_mode():
                    out[dev] = (
                        impute_dm(unet, sched[dev], torch.from_numpy(x).to(dev),
                                  torch.from_numpy(mask).to(dev), iter(noises),
                                  num_resample=2).cpu().numpy(),
                        impute_ldm(lunet, ae, 1.3, sched[dev], torch.from_numpy(lx).to(dev),
                                   torch.from_numpy(lmask).to(dev), iter(lnoises), num_resample=2,
                                   latent_erode=2).cpu().numpy())
                repaint_counts[dev] = read_counts()
            sig = expected_dm_launches(cfg, forwards=16)
            lat = expected_launches(lcfg, unet_forwards=16, decodes=1)
            want = {"K1": sig["K1"] + lat["K1"] + gn_counts(lcfg)["coder_gn"],
                    "K2": sig["K2"] + lat["K2"], "K3": 0}
            if repaint_counts["cuda"] != want:
                raise AssertionError(f"tiny RePaint: launches {repaint_counts['cuda']}, "
                                     f"expected {want}")
            for i, (name, m, known) in enumerate((("signal", mask, x), ("latent", lmask, lx))):
                errs[f"repaint_{name}"] = hold(f"RePaint {name}", out["cuda"][i], out["cpu"][i],
                                               2e-3, 2e-4)
                obs = np.broadcast_to(m, known.shape) == 1.0
                if not np.array_equal(out["cuda"][i][obs], known[obs]):
                    raise AssertionError(f"RePaint {name} on the card: the observed region "
                                         "differs from x_known")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    say("tiny-dm", k1_launches=counts["K1"], k2_launches=counts["K2"],
        k1_cluster_launches=cluster,
        train_grad_err_ratio=f"{held['train']['grad_err_ratio']:.3e}",
        cond_grad_err_ratio=f"{held['conditional']['grad_err_ratio']:.3e}",
        repaint_k1_launches=repaint_counts["cuda"]["K1"],
        **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()})
    free_card()
    return dict(max_abs_err=errs, held=held, launches=counts,
                repaint_launches=repaint_counts["cuda"])


def write_dm_run_dir(root: Path, cfg: Config, state: dict) -> Path:
    """A train-dm run dir as ``sample-dm`` and ``impute`` read it:
    config.yaml, best_model/ and final_model/, each a port run dir."""
    for name in ("best_model", "final_model"):
        (root / name).mkdir(parents=True)
        cfg.to_yaml(root / name / "config.yaml")
        save_params_npz(root / name / "params.npz", {"params": unet_state_to_jax(state)})
    cfg.to_yaml(root / "config.yaml")
    return root


def impute_cli(tmp: Path, name: str, windows: np.ndarray, *flags) -> dict:
    """``impute`` in this process on ``windows`` (one batch of 16), with
    the counts set to 0 before and read after: its seconds, the counts, and
    the output, whose observed samples must equal the input's."""
    inp, out = tmp / f"{name}_in.npy", tmp / f"{name}_out"
    np.save(inp, windows)
    profiling.reset()
    _, seconds = timed(run_cli, "impute", "--input", str(inp), "--output_dir", str(out),
                       "--mask_start", str(IMPUTE_MASK[0]), "--mask_len", str(IMPUTE_MASK[1]),
                       "--batch_size", str(IMPUTE_BATCH), *flags)
    counts = read_counts()
    imputed, mask = np.load(out / "imputed.npy"), np.load(out / "mask.npy")
    if imputed.shape != (len(windows), 1, 3000) or not np.isfinite(imputed).all():
        raise AssertionError(f"impute {name}: output {imputed.shape}")
    if not np.array_equal(imputed[:, 0, mask], windows[:, mask]) or mask.sum() != 3000 - IMPUTE_MASK[1]:
        raise AssertionError(f"impute {name}: the observed samples changed")
    return dict(seconds=seconds, windows_per_s=len(windows) / seconds, launches=counts,
                masked_std=float(imputed[:, 0, ~mask].std()))


def phase_dm_full(tmp: Path) -> dict:
    """M2: the DM path at full width (dm.yaml, bf16) on seeded weights in
    port run dirs. ``sample-dm`` (the CLI, as the warm-up: 64 seeds,
    DDIM-200 over the 1000-entry table, artifacts), then three timed
    batches of 64 through ``sample_dm_trials`` with their launch counts
    (median windows/s); ``train-dm`` (the CLI) on a synthetic npy tree of
    512 + 64 recordings, seven one-step epochs at batch 512 (median ms per
    step after the first, windows/s, peak memory, launch counts); ``impute``
    in signal mode (16 windows, 1000 RePaint steps) and in latent mode over
    the flagship LDM and AEKL, each one batch: seconds per batch, windows/s,
    launch counts, observed samples unchanged; ``warm-cache --targets ldm``
    on the serving phase's conditional config, in a process of its own."""
    cfg = dm_config()
    state = dm_state(cfg, SEED)
    run = write_dm_run_dir(tmp / "dm_run", cfg, state)
    warm_out = tmp / "dm_cli"
    profiling.reset()
    _, cli_s = timed(run_cli, "sample-dm", "--output_dir", str(warm_out), "--diffusion_path",
                     str(run), "--stop_seed", str(BATCH), "--batch_size", str(BATCH))
    want = expected_dm_launches(cfg, forwards=STEPS)
    out_dir = warm_out / "samples_ddpm_no-spectral_edfx"
    files = [len(list(out_dir.glob(f"{k}_*.npy"))) for k in ("sample", "psd_list")]
    if read_counts() != want or files != [BATCH, BATCH] or not (out_dir / "psd_list.npy").exists():
        raise AssertionError(f"sample-dm CLI: launches {read_counts()}, expected {want}; "
                             f"sample and PSD files {files}")
    say("dm-sample", cli_seconds=f"{cli_s:.3f}", k1_launches=want["K1"], k2_launches=want["K2"])
    seconds = []
    for i in range(TIMED_BATCHES):
        profiling.reset()
        out, sec = timed(sample_dm_trials, cfg, state, tmp / "dm_timed", i * BATCH,
                         (i + 1) * BATCH, BATCH, DM_TABLE, STEPS)
        seconds.append(sec)
        launches, shapes = read_counts(), read_shapes()
        if out.shape != (BATCH, 3000, 1) or not np.isfinite(out).all() or launches != want:
            raise AssertionError(f"DM batch {i}: output {out.shape}, launches {launches}")
        say("dm-sample", batch=i, seconds=f"{sec:.3f}", out_std=f"{out.std():.4f}")
    median = statistics.median(seconds)
    say("dm-sample", steps=STEPS, batches=TIMED_BATCHES, median_seconds=f"{median:.3f}",
        min_seconds=f"{min(seconds):.3f}", max_seconds=f"{max(seconds):.3f}",
        windows_per_s=f"{BATCH / median:.3f}")
    sample = dict(seconds=seconds, median_seconds=median, windows_per_s=BATCH / median,
                  cli_seconds=cli_s, launches=launches, shapes=shapes)

    tcfg = dm_config()
    tcfg.train.n_epochs, tcfg.train.val_interval = TRAIN_EPOCHS, 10 * TRAIN_EPOCHS
    tcfg.train.output_dir = str(tmp / "dm_train")
    tcfg.to_yaml(tmp / "dm_train.yaml")
    write_split(tmp, "dm_npy", DM_TRAIN_BATCH, VALID_WINDOWS, SEED + 7)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    profiling.reset()
    result, wall = timed(run_cli, "train-dm", "--config_file", str(tmp / "dm_train.yaml"),
                         "--path_train_ids", str(tmp / "dm_npy_train.csv"),
                         "--path_valid_ids", str(tmp / "dm_npy_valid.csv"),
                         "--path_pre_processed", str(tmp / "dm_npy"))
    counts, peak = read_counts(), torch.cuda.max_memory_allocated()
    want = expected_dm_launches(cfg, forwards=0, train_steps=TRAIN_EPOCHS)
    log = [json.loads(line) for line in
           (Path(result.run_dir) / "metrics_train.jsonl").read_text().splitlines()]
    losses, ms = [r["loss"] for r in log], [r["seconds"] * 1e3 for r in log[1:]]
    if counts != want or len(log) != TRAIN_EPOCHS or not np.isfinite(losses).all() or not (
            Path(result.run_dir) / "final_model" / "params.npz").exists():
        raise AssertionError(f"train-dm: launches {counts}, expected {want}; losses {losses}")
    step_ms = statistics.median(ms)
    train = dict(batch=DM_TRAIN_BATCH, losses=losses, step_ms=ms, median_step_ms=step_ms,
                 windows_per_s=DM_TRAIN_BATCH / step_ms * 1e3, peak_bytes=peak, wall_s=wall,
                 launches=counts)
    say("dm-train", batch=DM_TRAIN_BATCH, epochs=TRAIN_EPOCHS,
        losses=[f"{v:.4f}" for v in losses])
    say("dm-train", median_ms_per_step=f"{step_ms:.2f}", min_ms=f"{min(ms):.2f}",
        max_ms=f"{max(ms):.2f}", windows_per_s=f"{train['windows_per_s']:.2f}",
        peak_gib=f"{peak / 2**30:.2f}", wall_s=f"{wall:.1f}", **counts)
    free_card()

    ds = WindowDataset.from_raw(make_synthetic_dataset(IMPUTE_BATCH, 35.0, SEED + 8))
    windows = center_crop_valid(ds.epoch_windows(np.random.default_rng(SEED)))[..., 0]
    imputes = {"signal": impute_cli(tmp, "impute_signal", windows, "--diffusion_path",
                                    str(run))}
    want = expected_dm_launches(cfg, forwards=cfg.diffusion.timesteps)
    if imputes["signal"]["launches"] != want:
        raise AssertionError(f"impute signal: launches {imputes['signal']['launches']}, "
                             f"expected {want}")
    lcfg = flagship_config(steps=STEPS)
    unet_sd, ae_sd = seeded_weights(lcfg, SEED)
    aekl_dir, ldm_dir = write_run_dirs(tmp / "impute_ldm_runs", lcfg, unet_sd, ae_sd, 1.0)
    imputes["latent"] = impute_cli(tmp, "impute_latent", windows, "--diffusion_path",
                                   str(ldm_dir), "--best_model_path", str(aekl_dir))
    lat = expected_launches(lcfg, unet_forwards=lcfg.diffusion.timesteps, decodes=1)
    want = {"K1": lat["K1"] + gn_counts(lcfg)["coder_gn"], "K2": lat["K2"], "K3": 0}
    if imputes["latent"]["launches"] != want:
        raise AssertionError(f"impute latent: launches {imputes['latent']['launches']}, "
                             f"expected {want}")
    for mode, r in imputes.items():
        say("dm-impute", mode=mode, batch=IMPUTE_BATCH, steps=cfg.diffusion.timesteps,
            seconds_per_batch=f"{r['seconds']:.3f}", windows_per_s=f"{r['windows_per_s']:.3f}",
            k1_launches=r["launches"]["K1"], k2_launches=r["launches"]["K2"],
            masked_std=f"{r['masked_std']:.4f}")
    free_card()

    scfg = serve_config(flagship_config(steps=DPM_STEPS))
    scfg.to_yaml(tmp / "serve_ldm.yaml")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sleepgen_torch", "warm-cache", "--config_file",
                           str(tmp / "serve_ldm.yaml"), "--targets", "ldm"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    warm_s = time.perf_counter() - t0
    warmed = [line for line in proc.stdout.splitlines() if line.startswith("warmed ldm")]
    if proc.returncode != 0 or len(warmed) != 1:
        raise RuntimeError(f"warm-cache --targets ldm exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    say("dm-warm-cache", seconds=f"{warm_s:.2f}", line=warmed[0].replace(" ", "_"))
    return dict(sample=sample, train=train, impute=imputes,
                warm_cache=dict(seconds=warm_s, line=warmed[0]))


def dm_paths(shapes: dict, sample: dict | None = None) -> dict:
    """phase_timings' rows of the DM: K1 and K3 on one training step (phase
    3's), and K1 and K2 on a DDIM-200 batch of 64 (M2's) when given."""
    rows = {"K1 dm train": ("K1", "DM train step", shapes["dm_train"]["K1"],
                            shapes["dm_train_counts"]["K1"]),
            "K3 dm train": ("K3", "DM train step", shapes["dm_train"]["K3"],
                            shapes["dm_train_counts"]["K3"])}
    if sample is not None:
        rows.update({kid_row: (kid, "DM DDIM-200 batch", sample["shapes"][kid],
                               sample["launches"][kid])
                     for kid_row, kid in (("K1 dm", "K1"), ("K2 dm", "K2"))})
    return rows


def repaint_profile(tag: str, unet, cfg: Config, length: int, clip_sample: bool) -> dict:
    """RePaint steps as ``impute`` runs them: batch IMPUTE_BATCH, one pass
    per step, M2's masked span (in latent mode through its latent mask),
    the training schedule's betas. A step's work does not depend on t, so
    a schedule of a few entries stands for the 1000: twenty steps on the
    host clock, then five under torch.profiler (device time per step by
    kernel, busy share against each wall time)."""
    mask = torch.ones((1, 1, 3072), device="cuda")
    start = BORDER_PAD + IMPUTE_MASK[0]
    mask[..., start:start + IMPUTE_MASK[1]] = 0.0
    if length != 3072:
        mask = latent_observed_mask(mask, length)
    x = torch.randn((IMPUTE_BATCH, 1, length), device="cuda")
    model_fn = cond_model_fn(unet, None, 1.0)

    def steps(n: int):
        short = copy.deepcopy(cfg)
        short.diffusion.timesteps = n
        sched = T.make_schedule(short, "cuda")
        gen = C.make_generator(SEED, "cuda", 0)
        return lambda: ddpm_inpaint_loop(model_fn, sched, x, mask, gen, clip_sample=clip_sample)

    with torch.inference_mode():
        steps(2)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(20)()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        n = 5
        wall_ms, device_ms, top, n_kernels = device_profile(steps(n), 1)
    top = [dict(row, ms_per_run=row["ms_per_run"] / n) for row in top]  # per step
    out = dict(host_ms_per_step=host_ms, step_ms=wall_ms / n, device_ms_per_step=device_ms / n,
               busy_share=device_ms / wall_ms, busy_share_host_clock=device_ms / n / host_ms,
               top=top)
    say(tag, batch=IMPUTE_BATCH, length=length, host_ms_per_step=f"{host_ms:.3f}",
        profiled_ms_per_step=f"{out['step_ms']:.3f}",
        device_ms_per_step=f"{out['device_ms_per_step']:.3f}",
        busy_share=f"{out['busy_share']:.3f}",
        busy_share_host_clock=f"{out['busy_share_host_clock']:.3f}", kernels=n_kernels)
    for row in top[:6]:
        say(f"{tag}-top", ms_per_step=f"{row['ms_per_run']:.3f}", kernel=row["kernel"][:80])
    return out


def phase_dm_profile() -> dict:
    """Where a DM batch's, a RePaint step's and a DM training step's time
    goes: five full-width DDIM steps at batch 64 under torch.profiler
    (device time per step by kernel, busy share), RePaint steps of
    ``impute`` at batch 16 in signal mode and in latent mode (the flagship
    LDM at latent 768), and one training step at batch 512."""
    cfg = dm_config()
    unet = build_dm(cfg, dm_state(cfg, SEED), torch.device("cuda"))
    sched = dm_sampling_schedule(cfg, DM_TABLE, "cuda")
    x = torch.randn((BATCH, 1, 3072), device="cuda")
    n = 5
    with torch.inference_mode():
        ddim_sample_loop(unet, sched, x, 2)
        wall_ms, device_ms, top, n_kernels = device_profile(
            lambda: ddim_sample_loop(unet, sched, x, n), 1)
    top = [dict(row, ms_per_run=row["ms_per_run"] / n) for row in top]  # per step
    step = dict(step_ms=wall_ms / n, device_ms_per_step=device_ms / n,
                busy_share=device_ms / wall_ms, top=top)
    say("profile-dm", step_ms=f"{step['step_ms']:.3f}",
        device_ms_per_step=f"{step['device_ms_per_step']:.3f}",
        busy_share=f"{step['busy_share']:.3f}", kernels=n_kernels)
    for row in top[:8]:
        say("profile-dm-top", ms_per_step=f"{row['ms_per_run']:.3f}",
            kernel=row["kernel"][:80])
    repaint = {"signal": repaint_profile("profile-repaint-signal", unet, cfg, 3072, True)}
    del unet, x
    free_card()
    lcfg = flagship_config(steps=STEPS)
    lunet, _ = build_models(lcfg, *seeded_weights(lcfg, SEED), torch.device("cuda"))
    repaint["latent"] = repaint_profile("profile-repaint-latent", lunet, lcfg,
                                        lcfg.unet.image_size, False)
    del lunet
    free_card()
    unet, sched, opt = D.build_dm_trainer(cfg, "cuda")
    train_step = D.make_dm_train_step(unet, sched, opt, cfg.spectral, DTYPES[cfg.dtype])
    x = train_windows(DM_TRAIN_BATCH, SEED)
    gen = C.make_generator(cfg.train.seed, "cuda", C.TRAIN_STREAM, 0)
    t, noise, _ = D.draw_dm_step_inputs(gen, DM_TRAIN_BATCH, (1, 3072), sched.num_timesteps)
    train = profile_step("profile-dm-train", train_step, (x, t, noise))
    del unet, opt, train_step, x
    free_card()
    return dict(ddim_step=step, repaint_step=repaint, train_step=train)


# -- downstream decoding, its ingest and the evaluation tail (D1-D3) -----------

def decoders() -> dict:
    """The decode CLI's three decoders at their published widths, by
    variant: (a model, one item's shape in (.., C, T))."""
    return {"a": (lambda: TimeDistributedStager(n_chans=1, sfreq=100), (3, 1, 3000)),
            "b": (lambda: SleepStagerChambon2018(n_chans=1, sfreq=100, dropout=0.5), (1, 3000)),
            "c": (lambda: DeepSleepNet(n_outputs=5, sfreq=100), (1, 3000))}


def decoder_state(model: torch.nn.Module, seed: int) -> dict:
    """The trainer's initial weights (``flax_init_state``) with running
    means N(0, 0.1^2) and variances U(0.5, 1.5), so that no BatchNorm is
    the identity in eval mode."""
    sd = flax_init_state(model, seed)
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return sd


def decoder_run(make, state: dict, dev: str, x_eval: np.ndarray, batches: list) -> dict:
    """A forward in eval mode, then one training step per batch (the
    trainer's ``make_train_step``, AdamW at DECODE_HOLD_LR on the cosine
    schedule) from ``state`` on ``dev``: the eval logits, each step's loss
    and gradients, and the BatchNorm statistics after each step."""
    model = load_numpy_state(make(), state).to(dev)
    model.p_dropout = 0.0
    model.eval()
    with torch.no_grad():
        logits = host_copy(model(torch.from_numpy(x_eval).to(dev)))
    opt, sched = DEC.make_optimizer(model, DECODE_HOLD_LR, 1e-3, 3, len(batches[0][0]),
                                    len(batches[0][0]))
    class_w = torch.as_tensor(balanced_class_weights(batches[0][1]), device=dev)
    step = DEC.make_train_step(model, opt, sched, class_w)
    out = dict(logits=logits, losses=[], grads=[], stats=[])
    for x, y in batches:
        out["losses"].append(float(step(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))))
        out["grads"].append({k: host_copy(p.grad) for k, p in model.named_parameters()
                             if p.requires_grad})
        out["stats"].append({k: host_copy(v) for k, v in model.state_dict().items()
                             if k.endswith(("running_mean", "running_var"))})
    return out


def hold_decoder_run(got: dict, want: dict, what: str) -> dict:
    """Hold one ``decoder_run`` (card) to another (CPU); raise listing
    every disagreement. Eval logits and losses at the model bound (rtol
    2e-3 / atol 2e-4); each step's gradients within 2e-3 of each leaf's
    largest |g| plus 1e-6 of the model's largest (the rounding floor of a
    gradient zero in exact arithmetic: a convolution's bias before a
    BatchNorm in training mode); running variances rtol / atol 1e-5, and
    running means too, plus, after the first step, 0.2 lr: the noise-driven
    biases before them each move by lr with a sign of rounding, and the
    next batch mean with them (momentum 0.1, two sides)."""
    faults = []
    err = float(np.abs(got["logits"] - want["logits"]).max())
    if not np.allclose(got["logits"], want["logits"], rtol=2e-3, atol=2e-4):
        faults.append(f"eval logits: |err| {err:.3e}")
    for i, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        if not abs(g - w) <= 2e-4 + 2e-3 * abs(w):
            faults.append(f"step {i} loss {g:.6g}, expected {w:.6g}")
    grad_ratio = 0.0
    for i, (gg, wg) in enumerate(zip(got["grads"], want["grads"])):
        top_all = max(float(np.abs(w).max()) for w in wg.values())
        for k, w in wg.items():
            top, e = float(np.abs(w).max()), float(np.abs(gg[k] - w).max())
            if not e <= 2e-3 * top + 1e-6 * top_all:
                faults.append(f"step {i} gradient {k}: |err| {e:.3e}, leaf's largest {top:.3e}")
            grad_ratio = max(grad_ratio, e / (top + 1e-6 * top_all / 2e-3))
    stat_err = 0.0
    for i, (gs, ws) in enumerate(zip(got["stats"], want["stats"])):
        for k, w in ws.items():
            atol = 1e-5 + (0.2 * DECODE_HOLD_LR if i and k.endswith("mean") else 0.0)
            e = float(np.abs(gs[k] - w).max())
            if not np.allclose(gs[k], w, rtol=1e-5, atol=atol):
                faults.append(f"step {i} {k}: |err| {e:.3e}")
            stat_err = max(stat_err, e)
    if faults:
        raise AssertionError(f"{what}, {len(faults)} disagreements:\n" + "\n".join(faults))
    return dict(logits_err=err, grad_err_ratio=grad_ratio, stat_max_abs_err=stat_err)


def phase_tiny_decode() -> dict:
    """D1: each decoder at its published width, batch 8, fp32 with TF32
    off, dropout 0, on the card against the CPU from the same weights: a
    forward in eval mode and two training steps (``hold_decoder_run``)."""
    rng = np.random.default_rng(SEED + 50)
    out = {}
    for variant, (make, item) in decoders().items():
        with torch.device("meta"):
            state = decoder_state(make(), SEED + 51)
        x_eval = rng.standard_normal((8, *item)).astype(np.float32)
        batches = [(rng.standard_normal((8, *item)).astype(np.float32),
                    rng.permutation(np.arange(8) % 5)) for _ in range(2)]
        runs = {dev: decoder_run(make, state, dev, x_eval, batches) for dev in ("cuda", "cpu")}
        out[variant] = hold_decoder_run(runs["cuda"], runs["cpu"], f"decoder {variant}")
        say("tiny-decode", variant=variant, losses=[f"{v:.5f}" for v in runs["cuda"]["losses"]],
            **{k: f"{v:.3e}" for k, v in out[variant].items()})
    free_card()
    return out


def merged_hypnogram(labels: np.ndarray) -> list:
    """Stage annotations of consecutive 30 s epochs, runs of one stage
    merged into one annotation, as a Sleep-EDFx hypnogram holds them."""
    anns, start = [], 0
    for i in range(1, len(labels) + 1):
        if i == len(labels) or labels[i] != labels[start]:
            anns.append((30.0 * start, 30.0 * (i - start), STAGE_DESCRIPTIONS[labels[start]]))
            start = i
    return anns


def write_staged_edfs(edf_dir: Path) -> float:
    """DECODE_RECORDINGS synthetic staged nights of DECODE_NIGHT_EPOCHS 30 s
    epochs (``make_synthetic_staged``), each a PSG EDF (the windows x 20, in
    uV) and a hypnogram EDF; returns the seconds the data took."""
    t0 = time.perf_counter()
    x, y, rids = make_synthetic_staged(DECODE_RECORDINGS, DECODE_NIGHT_EPOCHS, seed=SEED + 52)
    edf_dir.mkdir()
    for rec in range(DECODE_RECORDINGS):
        m = rids == rec
        name = f"SC4{rec:02d}1E"
        write_edf(edf_dir / f"{name}0-PSG.edf", [x[m][..., 0].reshape(-1) * 20.0],
                  ["EEG Fpz-Cz"], 100)
        write_edf(edf_dir / f"{name}C-Hypnogram.edf", [np.zeros(100)], ["Marker"], 100,
                  merged_hypnogram(y[m]))
    return time.perf_counter() - t0


def decode_throughput(variant: str, x: np.ndarray, y: np.ndarray) -> dict:
    """The card's busy share over a stretch of the trainer's loop: the
    batch gathered and copied as ``train_decoder`` does it, then the step;
    DECODE_PROFILE_STEPS under torch.profiler after two warm-up steps."""
    model = decoders()[variant][0]()
    model = load_numpy_state(model, flax_init_state(model, SEED)).to("cuda")
    opt, sched = DEC.make_optimizer(model, 1e-3, 1e-3, DECODE_EPOCHS, len(x), DECODE_BATCH)
    step = DEC.make_train_step(model, opt, sched,
                               torch.as_tensor(balanced_class_weights(y), device="cuda"),
                               torch.Generator(device="cuda").manual_seed(SEED))
    order = np.random.default_rng(SEED).permutation(len(x))
    starts = itertools.cycle(range(0, len(x) - DECODE_BATCH + 1, DECODE_BATCH))

    def one():
        start = next(starts)
        idx = order[start:start + DECODE_BATCH]
        step(DEC.to_device(x[idx], torch.device("cuda")), torch.as_tensor(y[idx], device="cuda"))

    one(), one()
    wall_ms, device_ms, top, _ = device_profile(one, DECODE_PROFILE_STEPS)
    del model, opt, step
    free_card()
    return dict(step_ms=wall_ms, device_ms_per_step=device_ms, busy_share=device_ms / wall_ms,
                top=top[:6])


def phase_decode(tmp: Path) -> dict:
    """D2: the decode path at a realistic size. DECODE_RECORDINGS nights of
    DECODE_NIGHT_EPOCHS epochs as PSG + hypnogram EDFs, ``convert-edfx``,
    then ``decode`` in each variant for DECODE_EPOCHS epochs at the CLI's
    batch 64, each in this process through the umbrella CLI: steps/s and
    windows/s of training, seconds per epoch with both prediction passes,
    prediction windows/s, peak memory, the busy share of a profiled stretch
    of steps, the final balanced accuracy and the confusion matrix's sum
    (the valid set's size)."""
    edf_dir, npy = tmp / "decode_edf", tmp / "decode_npy"
    data_s = write_staged_edfs(edf_dir)
    _, convert_s = timed(run_cli, "convert-edfx", "--data_dir", str(edf_dir), "--out_dir", str(npy))
    t0 = time.perf_counter()
    x, y, rids = load_staged_dataset(npy, "Fpz-Cz")
    load_s = time.perf_counter() - t0
    if len(x) < 0.95 * DECODE_RECORDINGS * DECODE_NIGHT_EPOCHS or x.shape[1:] != (3000, 1):
        raise AssertionError(f"convert-edfx -> load_staged_dataset: {x.shape}")
    train_r, valid_r, _ = split_recordings(rids)
    say("decode-data", recordings=DECODE_RECORDINGS, windows=len(x), data_s=f"{data_s:.2f}",
        convert_s_per_recording=f"{convert_s / DECODE_RECORDINGS:.3f}", load_s=f"{load_s:.2f}")
    out = dict(recordings=DECODE_RECORDINGS, windows=len(x), data_s=data_s, convert_s=convert_s,
               convert_s_per_recording=convert_s / DECODE_RECORDINGS, load_s=load_s, variants={})
    for variant in decoders():
        m_tr, m_va = np.isin(rids, train_r), np.isin(rids, valid_r)
        if variant == "a":
            s_tr, s_va = sequence_indices(rids[m_tr], 3, 3), sequence_indices(rids[m_va], 3, 3)
            xtr, ytr = x[m_tr][s_tr], center_label(y[m_tr], s_tr)
            n_train, n_valid = len(s_tr), len(s_va)
        else:
            xtr, ytr = x[m_tr], y[m_tr]
            n_train, n_valid = int(m_tr.sum()), int(m_va.sum())
        run_dir = tmp / f"decode_{variant}"
        free_card()
        torch.cuda.reset_peak_memory_stats()
        res, cli_s = timed(run_cli, "decode", "--data_dir", str(npy), "--variant", variant,
                           "--n_epochs", str(DECODE_EPOCHS), "--batch_size", str(DECODE_BATCH),
                           "--output_dir", str(run_dir))
        peak = torch.cuda.max_memory_allocated()
        hist = json.loads((run_dir / "history.json").read_text())
        cm = np.load(run_dir / "confusion_matrix.npy")
        acc = hist[-1]["valid_bal_acc"]
        if (len(hist) != DECODE_EPOCHS or cm.sum() != n_valid or not 0.0 <= acc <= 1.0
                or not all(np.isfinite(h["loss"]) for h in hist)):
            raise AssertionError(f"decode {variant}: history {hist}, confusion sum {cm.sum()}, "
                                 f"expected {n_valid}")
        steps = -(-n_train // DECODE_BATCH)
        epochs = res.epoch_seconds
        train_s = statistics.median(e["train_s"] for e in epochs)
        predict_s = statistics.median(e["predict_s"] for e in epochs)
        busy = decode_throughput(variant, xtr, ytr)
        row = dict(n_train=n_train, n_valid=n_valid, cli_s=cli_s, epoch_seconds=epochs,
                   steps_per_s=steps / train_s, train_windows_per_s=n_train / train_s,
                   epoch_s=train_s + predict_s,
                   predict_windows_per_s=(n_train + n_valid) / predict_s, peak_bytes=peak,
                   final_valid_bal_acc=acc, confusion_sum=int(cm.sum()),
                   losses=[h["loss"] for h in hist], **busy)
        out["variants"][variant] = row
        say("decode", variant=variant, train=n_train, valid=n_valid, cli_s=f"{cli_s:.2f}",
            steps_per_s=f"{row['steps_per_s']:.2f}",
            train_windows_per_s=f"{row['train_windows_per_s']:.1f}",
            epoch_s=f"{row['epoch_s']:.2f}",
            predict_windows_per_s=f"{row['predict_windows_per_s']:.1f}",
            peak_gib=f"{peak / 2**30:.3f}", busy_share=f"{busy['busy_share']:.3f}",
            step_ms=f"{busy['step_ms']:.3f}", device_ms_per_step=f"{busy['device_ms_per_step']:.3f}",
            valid_bal_acc=f"{acc:.4f}", confusion_sum=int(cm.sum()))
    return out


def band_eval_batch(cfg: Config, run: Path, ids: Path, npy: Path) -> tuple:
    """One reconstruction of band-eval's BAND_EVAL_WINDOWS test windows in
    one fp32 call, as the CLI makes it, with the counts set to 0 before and
    read after: 26 K1 launches. Returns the counts and K1's shapes."""
    ae = load_aekl(run, cfg, torch.device("cuda"))
    windows = load_split(ids, npy).epoch_windows(np.random.default_rng(2))[:BAND_EVAL_WINDOWS]
    x = torch.as_tensor(to_bcl(windows), device="cuda")
    profiling.reset()
    with torch.inference_mode():
        recon = ae.reconstruct(x)
    torch.cuda.synchronize()
    counts, shapes = read_counts(), read_shapes()
    want = recon_launches(cfg, batches=1)
    if counts != want or recon.shape != x.shape or not bool(torch.isfinite(recon).all()):
        raise AssertionError(f"band-eval batch: launches {counts}, expected {want}")
    require_forms("band-eval batch", counts, shapes["forms"])
    say("band-eval-batch", windows=BAND_EVAL_WINDOWS, k1_launches=counts["K1"], **shapes["forms"])
    del ae, x, recon
    free_card()
    return counts, shapes


def phase_eval_tail(tmp: Path, checks: dict, stage1_run: Path) -> dict:
    """D3: ``sample-ae`` on aekl_eeg.yaml's AEKL (seeded weights in a port
    run dir) over E2's test split at batch 64: its 26 K1 launches per batch,
    the CLI's seconds and reconstruction windows/s; K1 held to its plain
    version at band-eval's batch-512 shapes, fp32 and bf16; ``band-eval``
    in each mode with MS-SSIM (K1's launches in the reconstruction mode)
    and once with both metrics (FID on seeded USleep weights); the report
    figures where matplotlib is present."""
    cfg = stage1_config()
    run = tmp / "d3_aekl"
    run.mkdir()
    cfg.to_yaml(run / "config.yaml")
    with torch.device("meta"):
        ae_sd = seeded_state_dict(build_aekl(cfg), SEED + 53)
    save_params_npz(run / "params.npz", {"params": aekl_state_to_jax(ae_sd)})
    npy, ids = tmp / "eval_npy", tmp / "eval_test.csv"
    figures = HAVE["matplotlib"]
    batches = EVAL_WINDOWS // BATCH
    profiling.reset()
    out_dir, cli_s = timed(run_cli, "sample-ae", "--output_dir", str(tmp / "sample_ae"),
                           "--stage1_path", str(run), "--path_train_ids", str(ids),
                           "--path_pre_processed", str(npy), "--batch_size", str(BATCH),
                           *([] if figures else ["--no_figures"]))
    counts = read_counts()
    files = sorted(out_dir.glob("synthetic_trial_eeg_*.npy"))
    first = np.load(files[0])
    if counts != recon_launches(cfg, batches=batches) or len(files) != batches or (
            first.shape != (BATCH, 1, 3072) or not np.isfinite(first).all()):
        raise AssertionError(f"sample-ae: launches {counts}, {len(files)} files, {first.shape}")
    ae = load_aekl(run, cfg, torch.device("cuda"))
    windows = load_split(ids, npy).epoch_windows(np.random.default_rng(cfg.train.seed))

    def reconstruct_all():
        with torch.inference_mode():
            for i in range(0, len(windows), BATCH):
                ae.reconstruct(torch.as_tensor(to_bcl(windows[i:i + BATCH]), device="cuda"))

    reconstruct_all()
    recon_s = [timed(reconstruct_all)[1] for _ in range(3)]
    del ae
    free_card()
    say("sample-ae", batches=batches, k1_launches_per_batch=counts["K1"] // batches,
        cli_s=f"{cli_s:.3f}", windows_per_s=f"{EVAL_WINDOWS / statistics.median(recon_s):.1f}",
        seconds_min_max=f"{min(recon_s):.4f}-{max(recon_s):.4f}")

    band_counts, band_shapes = band_eval_batch(cfg, run, ids, npy)
    check_new_shapes(checks, "band-eval reconstruction (batch 512)", {"K1": band_shapes["K1"]})
    samples = tmp / "dpm_samples"
    common = ["--path_test_ids", str(ids), "--path_pre_processed", str(npy), "--sample_dir",
              str(samples), "--best_model_path", str(run), "--max_windows",
              str(BAND_EVAL_WINDOWS)]
    modes = {}
    for mode, metric in (("test_pairs", "ms_ssim"), ("sample_pairs", "ms_ssim"),
                         ("sample_vs_test", "ms_ssim"), ("reconstruction", "ms_ssim"),
                         ("test_pairs", "both")):
        profiling.reset()
        res, secs = timed(run_cli, "band-eval", "--mode", mode, "--metric", metric, *common,
                          "--output_dir", str(tmp / "band_eval"))
        launches = read_counts()
        want = recon_launches(cfg, 1) if mode == "reconstruction" else {"K1": 0, "K2": 0, "K3": 0}
        values = [v for entry in res.values() for v in entry.values()]
        if (list(res) != ["all", *EEG_BANDS] or launches != want
                or not all(np.isfinite(v) for v in values)
                or not all(-1.0 <= e["ms_ssim_mean"] <= 1.0 for e in res.values())
                or (metric == "both" and not all(e["fid"] >= -1e-6 for e in res.values()))):
            raise AssertionError(f"band-eval {mode} {metric}: {res}, launches {launches}")
        tag = f"{mode}_{metric}"
        modes[tag] = dict(seconds=secs, results=res, launches=launches)
        say("band-eval", mode=mode, metric=metric, seconds=f"{secs:.3f}",
            k1_launches=launches["K1"],
            ms_ssim_all=f"{res['all']['ms_ssim_mean']:.5f}",
            **({"fid_all": f"{res['all']['fid']:.5f}"} if metric == "both" else {}))
    if figures:
        want_files = [out_dir / "reconstruction_RECONSTRUCTION_0.pdf",
                      *sorted(stage1_run.glob("reconstruction_RECONSTRUCTION_*.pdf")),
                      *sorted(stage1_run.glob("compare_SPECTRAL_RECONSTRUCTION_*.pdf"))]
        if len(want_files) < 3 or not all(f.exists() for f in want_files):
            raise AssertionError(f"report figures: {want_files}")
        say("reports", figures=len(want_files))
    else:
        say("reports", matplotlib="missing", figures=0, sample_ae="--no_figures")
    return dict(sample_ae=dict(cli_s=cli_s, launches=counts, seconds=recon_s,
                               windows_per_s=EVAL_WINDOWS / statistics.median(recon_s)),
                band_eval=modes, band_counts=band_counts, band_shapes=band_shapes,
                figures=figures)


# -- the first-generation pipeline, int8 sampling, the long window ------------
# (phase 3's v1, int8 and long-window steps; V1, V2, Q1, W1)

V1_BATCH = 16  # the v1 trainers' batch_size
V1_EPOCHS = 5  # V2's trainers: one step an epoch, one validation after the last
V1_TIMESTEPS = 1000  # train_v1_ddpm's table, and the ancestral chain's length
V1_LATENT = (3, 768)  # embed_dim 3 at 3072 / 4
V1_PROFILE_STEPS = 5
# benches/long_window.py: the default UNet on windows of 12288 (3072 attention
# tokens), DDIM-50 at batch 16; 1000 does not divide 3072
LONG_WINDOW, LONG_STEPS, LONG_BATCH, LONG_BLOCK, LONG_BAD_BLOCK = 12288, 50, 16, 512, 1000
QUANT_REL_L2 = 0.05  # tests/test_quant.py's bound on an int8 output


def v1_aekl() -> AutoencoderKLV1:
    """The v1 VAE at the trainers' defaults (n_channels 64, ch_mult (1, 2, 4),
    embed_dim 3, z_channels 3, G 32) on 3072-sample windows."""
    return AutoencoderKLV1(resolution=3072)


def v1_unet(ae: AutoencoderKLV1) -> UNet1d:
    """train_v1_ddpm's UNet: mc 64, channel_mult (1, 2), attention at ds 2,
    G 32, in and out embed_dim."""
    return UNet1d(in_channels=ae.embed_dim, out_channels=ae.embed_dim, model_channels=64,
                  channel_mult=(1, 2), attention_resolutions=(2,))


def n_modules(model: torch.nn.Module, kind) -> int:
    return sum(isinstance(m, kind) for m in model.modules())


def unet_launches(unet: UNet1d) -> dict:
    """Launches of one UNet forward without autograd, derived from its
    blocks: K2 at both chains of each resblock that neither resamples nor
    scales and shifts its second norm, at chain 2 of one that resamples and
    at chain 1 of one that scales and shifts; K1 at the chains K2 does not
    run, every attention norm and the output norm; an int8 UNet runs K1 at
    every GroupNorm and no K2."""
    if unet.config["quantized"]:
        return {"K1": n_modules(unet, GroupNorm32), "K2": 0, "K3": 0}
    blocks = [m for m in unet.modules() if isinstance(m, TimestepResBlock)]
    unfused = sum(b.up or b.down for b in blocks) + sum(b.scale_shift for b in blocks)
    return {"K1": unfused + n_modules(unet, AttentionBlock1d) + 1,
            "K2": 2 * len(blocks) - unfused, "K3": 0}


def times(counts: dict, n: int, plus: dict | None = None) -> dict:
    """n x counts (+ plus), kernel by kernel."""
    return {k: n * v + (plus or {}).get(k, 0) for k, v in counts.items()}


def v1_launches(ae: AutoencoderKLV1, unet: UNet1d) -> dict:
    """Launches of each v1 path, derived from the models: an encoder step
    runs K1 at every VAE GroupNorm and K3 at each for its gradient (the
    discriminator has none); an evaluation batch K1 at each; a DDPM step K1
    at the encoder's (the frozen encode) and at every UNet GroupNorm, K3 at
    the UNet's; an ancestral step the UNet forward's K1 and K2; the decode
    K1 at the decoder's. No K2 in training."""
    vae, ugn = n_modules(ae, GroupNorm32), n_modules(unet, GroupNorm32)
    return dict(encoder_step={"K1": vae, "K2": 0, "K3": vae},
                eval_batch={"K1": vae, "K2": 0, "K3": 0},
                ddpm_step={"K1": n_modules(ae.encoder, GroupNorm32) + ugn, "K2": 0, "K3": ugn},
                sample_step=unet_launches(unet),
                decode={"K1": n_modules(ae.decoder, GroupNorm32), "K2": 0, "K3": 0})


def counted(path: str, want: dict, fn):
    """fn() with the counts set to 0 before and read after, held to
    ``want``: (its result, counts, shapes)."""
    profiling.reset()
    out = fn()
    torch.cuda.synchronize()
    counts, shapes = read_counts(), read_shapes()
    if counts != want:
        raise AssertionError(f"{path}: launches {counts}, expected {want}")
    return out, counts, shapes


def v1_encoder_inputs(seed: int) -> tuple:
    """A batch of 16 windows (B, 1, 3072) fp32 and the encoder's eps of step 0."""
    gen = C.make_generator(seed, "cuda", C.V1_ENCODER_STREAM, 0)
    return (train_windows(V1_BATCH, seed),
            torch.randn((V1_BATCH, *V1_LATENT), generator=gen, device="cuda"))


def phase_v1_steps() -> dict:
    """One full-width step of each v1 path on the card, fp32, batch 16, with
    the counts held to ``v1_launches``: an encoder step from
    ``init_v1_encoder_state``'s weights, a DDPM step over that VAE, one
    ancestral step at t 999 and the decode. Returns {path: (counts,
    shapes)}: the shapes phase 3 checks (K1 and K3 in fp32 at G 32, groups
    of 3,072-12,288 elements; K2's fp32 path at C_out 64 and 128)."""
    ae = v1_aekl()
    state = V.init_v1_encoder_state(ae, DiscriminatorV1(), SEED, device="cuda")
    unet = v1_unet(ae).cuda()
    load_numpy_state(unet, T.init_unet_state(unet, SEED))
    want = v1_launches(ae, unet)
    x, eps = v1_encoder_inputs(SEED)
    out = {}
    metrics, *out["encoder_step"] = counted("v1 encoder step", want["encoder_step"],
                                            lambda: V.make_v1_encoder_train_step(state)(x, eps))
    tbl = DDPMTables.create("linear", V1_TIMESTEPS, 0.0015, 0.0195, device="cuda")
    ddpm = V.make_v1_ddpm_train_step(tbl, unet, ae.eval(), torch.optim.Adam(unet.parameters(),
                                                                           lr=2.5e-5))
    gen = C.make_generator(SEED, "cuda", C.V1_DDPM_STREAM, 0)
    draws = V.draw_v1_ddpm_inputs(gen, V1_BATCH, V1_LATENT, V1_TIMESTEPS)
    ddpm_metrics, *out["ddpm_step"] = counted("v1 DDPM step", want["ddpm_step"],
                                              lambda: ddpm(x, *draws))
    with torch.inference_mode():
        z = torch.randn((V1_BATCH, *V1_LATENT), device="cuda")
        t = torch.full((V1_BATCH,), V1_TIMESTEPS - 1, dtype=torch.long, device="cuda")
        _, *out["sample_step"] = counted("v1 ancestral step", want["sample_step"],
                                         lambda: p_sample(tbl, unet, z, t, torch.randn_like(z)))
        _, *out["decode"] = counted("v1 decode", want["decode"],
                                    lambda: ae.reconstruct_ldm_outputs(z))
    values = {k: float(v) for k, v in {**metrics, **ddpm_metrics}.items()}
    if not all(np.isfinite(v) for v in values.values()):
        raise AssertionError(f"v1 steps: metrics {values}")
    say("v1-steps", batch=V1_BATCH, **{f"{p}_{k.lower()}": c[k] for p, (c, _) in out.items()
                                       for k in ("K1", "K2", "K3") if c[k]},
        **{f"{p}_shapes": sum(len(s[k]) for k in ("K1", "K2", "K3")) for p, (_, s) in
           out.items()})
    del state, unet, ddpm, x, eps
    free_card()
    return out


def long_window_config(block: int) -> Config:
    """``benches/long_window.py``'s configuration: the default UNet (mc 128,
    [1, 2, 4], attention [8, 4], G 32) on windows of 12288, one channel in
    and out, bf16, the LDM's sampling schedule; ``kv_block_size`` block."""
    cfg = Config()
    cfg.unet.image_size, cfg.unet.kv_block_size = LONG_WINDOW, block
    return cfg


def long_window_inputs(cfg: Config) -> tuple:
    """(UNet from seeded weights, sampling schedule, x_T (16, 1, 12288))."""
    unet = build_dm(cfg, dm_state(cfg, SEED + 95), torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x_T = torch.randn((LONG_BATCH, 1, LONG_WINDOW), generator=gen, device="cuda")
    return unet, sampling_schedule(cfg, "cuda"), x_T


def phase_long_window_step() -> tuple:
    """One DDIM step of the long window (batch 16, bf16, block 512) with the
    counts held to ``unet_launches``: the shapes phase 3 checks (K1
    groups of 49,152 elements at G 32, K2 at L 12288)."""
    unet, sched, x_T = long_window_inputs(long_window_config(LONG_BLOCK))
    with torch.inference_mode():
        _, counts, shapes = counted("long-window DDIM step", unet_launches(unet),
                                    lambda: ddim_sample_loop(unet, sched, x_T, 1))
    say("long-step", batch=LONG_BATCH, window=LONG_WINDOW, k1_launches=counts["K1"],
        k2_launches=counts["K2"], k1_shapes=len(shapes["K1"]), k2_shapes=len(shapes["K2"]),
        **shapes["forms"])
    del unet, x_T
    free_card()
    return counts, shapes


def quant_launches(cfg: Config, forwards: int, decodes: int) -> dict:
    """The int8 sampler's launches: K1 at every UNet GroupNorm per forward
    (its resblock convolutions are int8, so no K2) and at every decoder
    GroupNorm per decode."""
    n = gn_counts(cfg)
    return {"K1": forwards * n["unet_gn"] + decodes * n["coder_gn"], "K2": 0, "K3": 0}


def phase_quant_step(tmp: Path) -> tuple:
    """One DDIM step of the flagship int8 sampler through
    ``sample_ldm_trials(quantized=True)`` at batch 64, with the counts held
    to ``quant_launches``: K1's shapes at every UNet GroupNorm."""
    cfg = flagship_config(steps=1)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    _, counts, shapes = counted(
        "int8 DDIM step", quant_launches(cfg, 1, 1),
        lambda: sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "q_warmup", 0, BATCH, BATCH,
                                  compute_psd=False, quantized=True))
    say("int8-step", batch=BATCH, k1_launches=counts["K1"], k2_launches=counts["K2"],
        k1_shapes=len(shapes["K1"]), **shapes["forms"])
    free_card()
    return counts, shapes


def v1_tiny_models(seed: int):
    """Seeded state dicts (no zero-initialised layer, so that every
    gradient of a first step is live) of the tiny v1 VAE (n_channels 8,
    ch_mult (1, 2), one resblock a level, G 4, embed_dim 3, L 256), v1
    PatchGAN (ndf 8, 2 layers) and UNet (mc 16, [1, 2], attention [2], G 4)."""
    with torch.device("meta"):
        ae, disc, unet = (AutoencoderKLV1(**V1_TINY_AE), DiscriminatorV1(ndf=8, n_layers=2),
                          UNet1d(**V1_TINY_UNET))
    return (seeded_state_dict(ae, seed), seeded_state_dict(disc, seed + 1),
            seeded_state_dict(unet, seed + 2))


V1_TINY_AE = dict(embed_dim=3, n_channels=8, z_channels=3, ch_mult=(1, 2), num_res_blocks=1,
                  resolution=256, num_groups=4)
V1_TINY_UNET = dict(in_channels=3, out_channels=3, model_channels=16, channel_mult=(1, 2),
                    attention_resolutions=(2,), num_groups=4)


def flat(tree, prefix: str) -> dict:
    """A nested parameter tree as {prefix/path: numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def v1_state(ae: AutoencoderKLV1, disc: DiscriminatorV1) -> dict:
    """The VAE's parameters in the JAX tree's layout (its q, k and v convs
    fused into one qkv leaf as JAX holds them: the k bias alone has only a
    rounding's gradient, softmax ignoring a shift of k) and the
    discriminator's state dict, BatchNorm statistics included, on the host."""
    return {**flat(aekl_v1_state_to_jax(ae.state_dict()), "ae"),
            **{f"disc.{k}": host_copy(v) for k, v in disc.state_dict().items()}}


def v1_grads(ae: AutoencoderKLV1, disc: DiscriminatorV1) -> dict:
    """The gradients, keyed as ``v1_state``."""
    return {**flat(aekl_v1_state_to_jax({k: p.grad for k, p in ae.named_parameters()}), "ae"),
            **{f"disc.{k}": host_copy(p.grad) for k, p in disc.named_parameters()}}


def tiny_v1_run(dev: str, x: np.ndarray, eps: list, states: tuple) -> dict:
    """Steps of the v1 encoder trainer on ``dev`` from the seeded states
    with the trainers' clipped Adams, one per eps: each step's metrics and
    (clipped) gradients, and the state before and after (``v1_state``)."""
    ae_sd, disc_sd, _ = states
    with torch.device(dev):
        ae = load_numpy_state(AutoencoderKLV1(**V1_TINY_AE), ae_sd)
        disc = load_numpy_state(DiscriminatorV1(ndf=8, n_layers=2), disc_sd)
    state = V.V1EncoderState(ae, disc, torch.optim.Adam(ae.parameters(), lr=1e-4),
                             torch.optim.Adam(disc.parameters(), lr=5e-4))
    step = V.make_v1_encoder_train_step(state)
    before, metrics, grads = v1_state(ae, disc), [], []
    for e in eps:
        m = step(torch.from_numpy(x).to(dev), torch.from_numpy(e).to(dev))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(v1_grads(ae, disc))
    return dict(metrics=metrics, grads=grads, before=before, after=v1_state(ae, disc))


def tiny_v1_ddpm_run(dev: str, x: np.ndarray, draws: tuple, states: tuple) -> dict:
    """One v1 DDPM step on ``dev`` over the tiny VAE, Adam at 2.5e-5: its
    metrics and gradients, and the UNet before and after."""
    ae_sd, _, unet_sd = states
    with torch.device(dev):
        ae = load_numpy_state(AutoencoderKLV1(**V1_TINY_AE), ae_sd).eval()
        unet = load_numpy_state(UNet1d(**V1_TINY_UNET), unet_sd)
    tbl = DDPMTables.create("linear", V1_TIMESTEPS, 0.0015, 0.0195, device=dev)
    step = V.make_v1_ddpm_train_step(tbl, unet, ae, torch.optim.Adam(unet.parameters(),
                                                                    lr=2.5e-5))
    before = {k: host_copy(v) for k, v in unet.state_dict().items()}
    m = step(*(torch.from_numpy(a).to(dev) for a in (x, *draws)))
    return dict(metrics=[{k: float(v) for k, v in m.items()}],
                grads=[{k: host_copy(p.grad) for k, p in unet.named_parameters()}],
                before=before, after={k: host_copy(v) for k, v in unet.state_dict().items()})


def tiny_v1_sample(dev: str, noise: list, states: tuple) -> np.ndarray:
    """``p_sample_loop`` over a 4-entry table on the tiny UNet from the
    given draws (x_T, then one a step), then the VAE's decode, fp32."""
    ae_sd, _, unet_sd = states
    with torch.device(dev):
        ae = load_numpy_state(AutoencoderKLV1(**V1_TINY_AE), ae_sd).eval()
        unet = load_numpy_state(UNet1d(**V1_TINY_UNET), unet_sd).eval()
    tbl = DDPMTables.create("linear", 4, 0.0015, 0.0195, device=dev)
    with torch.inference_mode():
        z = p_sample_loop(tbl, unet, noise[0].shape, iter(noise), device=dev)
        return ae.reconstruct_ldm_outputs(z).cpu().numpy()


def phase_tiny_v1() -> dict:
    """V1: the v1 pipeline at tiny widths on the card (K1, K3, K2 in fp32 at
    G 4) against the CPU (plain versions), fp32 with TF32 off, from the same
    seeded weights and draws: two encoder steps and one DDPM step, each
    held by ``hold_tiny_stage1`` with the v1 metrics; ``p_sample_loop``-4
    plus the decode at the model bound (rtol 2e-3 / atol 2e-4); launch
    counts as derived."""
    states = v1_tiny_models(SEED + 100)
    rng = np.random.default_rng(SEED + 101)
    b, length, latent = 4, 256, (3, 128)
    x = rng.uniform(size=(b, 1, length)).astype(np.float32)
    eps = [rng.standard_normal((b, *latent)).astype(np.float32) for _ in range(2)]
    draws = (rng.standard_normal((b, *latent)).astype(np.float32),
             rng.integers(0, V1_TIMESTEPS, b).astype(np.int64),
             rng.standard_normal((b, *latent)).astype(np.float32))
    noise = [torch.from_numpy(rng.standard_normal((2, *latent)).astype(np.float32))
             for _ in range(5)]
    with torch.device("meta"):
        ae, unet = AutoencoderKLV1(**V1_TINY_AE), UNet1d(**V1_TINY_UNET)
    want = v1_launches(ae, unet)
    card, counts, _ = counted("tiny v1 encoder steps", times(want["encoder_step"], 2),
                              lambda: tiny_v1_run("cuda", x, eps, states))
    held = hold_tiny_stage1(card, tiny_v1_run("cpu", x, eps, states), V.ENCODER_METRICS,
                            "tiny v1 encoder trainer")
    card_d, _, _ = counted("tiny v1 DDPM step", want["ddpm_step"],
                           lambda: tiny_v1_ddpm_run("cuda", x, draws, states))
    held_d = hold_tiny_stage1(card_d, tiny_v1_ddpm_run("cpu", x, draws, states),
                              V.DDPM_METRICS, "tiny v1 DDPM step")
    sample, sample_counts, _ = counted(
        "tiny v1 ancestral loop", times(want["sample_step"], 4, want["decode"]),
        lambda: tiny_v1_sample("cuda", noise, states))
    cpu = tiny_v1_sample("cpu", noise, states)
    np.testing.assert_allclose(sample, cpu, rtol=2e-3, atol=2e-4,
                               err_msg="tiny v1 p_sample_loop + decode: card vs CPU")
    err = float(np.abs(sample - cpu).max())
    say("tiny-v1", losses=[f"{m['loss']:.5f}" for m in card["metrics"]],
        grad_err_ratio=f"{held['grad_err_ratio']:.3e}",
        update_err_ratio=f"{held['update_err_ratio']:.3e}",
        ddpm_loss=f"{card_d['metrics'][0]['loss']:.5f}",
        ddpm_grad_err_ratio=f"{held_d['grad_err_ratio']:.3e}",
        sample_max_abs_err=f"{err:.3e}", k1_launches=counts["K1"], k3_launches=counts["K3"],
        sample_k2_launches=sample_counts["K2"])
    return dict(metrics=card["metrics"], held=held, ddpm_metrics=card_d["metrics"],
                ddpm_held=held_d, sample_max_abs_err=err, launches=counts,
                sample_launches=sample_counts)


def host_ms(fn, n: int) -> list:
    """ms of each of n calls of fn on the host clock, each ended by a
    synchronize."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def step_timing(tag: str, step, inputs: tuple) -> dict:
    """A step's ms on the host clock (median of five after the
    warm-up) and, under torch.profiler, on the device, with the busy share
    (device ms / wall ms of the profiled step)."""
    ms = host_ms(lambda: step(*inputs), V1_PROFILE_STEPS)
    prof = profile_step(f"{tag}-profile", step, inputs)
    out = dict(host_ms=statistics.median(ms), host_ms_all=ms, **prof)
    say(tag, host_ms=f"{out['host_ms']:.3f}", device_ms=f"{prof['device_ms_per_step']:.3f}",
        busy_share=f"{prof['busy_share']:.3f}")
    return out


def phase_v1_full(tmp: Path) -> dict:
    """V2: the v1 pipeline through its trainers at their default widths on
    3072-sample windows (batch 16, fp32), counts set to 0 before and read
    after each call and held to ``v1_launches``: ``train_v1_encoder`` for
    five one-step epochs with one validation after the last (wall seconds,
    peak memory, best L1, run dir); ``train_v1_ddpm`` over its final_model
    for five one-step epochs; one ``p_sample_loop`` of 1000 steps at batch
    16 and ``reconstruct_ldm_outputs`` (seconds, windows/s, ms per step,
    peak memory; K2's weight re-layouts over the chain held to one per K2
    weight); then each step timed on the host clock and profiled on
    the device (encoder step, DDPM step, ancestral step)."""
    train_ds, valid_ds = write_split(tmp, "v1_npy", V1_BATCH, V1_BATCH, SEED + 90)
    with torch.device("meta"):
        probe = v1_aekl()
        want = v1_launches(probe, v1_unet(probe))
    out = {}

    def run_entry(name: str, expected: dict, fn):
        free_card()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result, counts, _ = counted(name, expected, fn)
        out[name] = dict(seconds=time.perf_counter() - t0, launches=counts,
                         peak_bytes=torch.cuda.max_memory_allocated())
        return result

    enc_dir, ddpm_dir = tmp / "v1_encoder", tmp / "v1_ddpm"
    best, state = run_entry(
        "train_v1_encoder", times(want["encoder_step"], V1_EPOCHS, want["eval_batch"]),
        lambda: V.train_v1_encoder(train_ds, valid_ds, enc_dir, n_epochs=V1_EPOCHS,
                                   batch_size=V1_BATCH, val_interval=V1_EPOCHS, device="cuda"))
    log = [json.loads(line) for line in (enc_dir / "metrics_train.jsonl").read_text().splitlines()]
    missing = [n for n in ("best_model/params.npz", "final_model/params.npz",
                           f"checkpoints/step_{V1_EPOCHS:08d}.pt") if not (enc_dir / n).exists()]
    if (missing or not np.isfinite(best) or len(log) != V1_EPOCHS
            or not all(np.isfinite(r[k]) for r in log for k in V.ENCODER_METRICS)):
        raise AssertionError(f"train_v1_encoder: missing {missing}, best {best}, log {log}")
    out["train_v1_encoder"].update(best_l1=best, log=log)
    del state
    stage1 = aekl_v1_state_from_jax(load_params_npz(enc_dir / "final_model" / "params.npz"))
    unet = run_entry("train_v1_ddpm", times(want["ddpm_step"], V1_EPOCHS),
                  lambda: V.train_v1_ddpm(train_ds, stage1, ddpm_dir, v1_aekl(),
                                          n_epochs=V1_EPOCHS, batch_size=V1_BATCH,
                                          device="cuda"))
    log = [json.loads(line) for line in (ddpm_dir / "metrics_train.jsonl").read_text().splitlines()]
    if (not (ddpm_dir / "final_model" / "params.npz").exists() or len(log) != V1_EPOCHS
            or not all(np.isfinite(r[k]) for r in log for k in V.DDPM_METRICS)):
        raise AssertionError(f"train_v1_ddpm: log {log}")
    out["train_v1_ddpm"].update(log=log)

    with torch.device("cuda"):
        ae = load_numpy_state(v1_aekl(), stage1).eval()
    unet.eval()
    tbl = DDPMTables.create("linear", V1_TIMESTEPS, 0.0015, 0.0195, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def ancestral():
        with torch.inference_mode():
            z = p_sample_loop(tbl, unet, (V1_BATCH, *V1_LATENT), gen)
            return ae.reconstruct_ldm_outputs(z), z

    signal, z = run_entry("ancestral", times(want["sample_step"], V1_TIMESTEPS, want["decode"]),
                       ancestral)
    anc = out["ancestral"]
    # each K2 launch of a forward has its own weight, laid out once for the
    # whole chain (the weights were made outside inference mode)
    anc["relayouts"] = read_relayouts()
    if anc["relayouts"] != want["sample_step"]["K2"]:
        raise AssertionError(f"v1 ancestral batch: {anc['relayouts']} K2 weight re-layouts "
                             f"over {anc['launches']['K2']} launches, expected one per "
                             f"weight, {want['sample_step']['K2']}")
    if signal.shape != (V1_BATCH, 1, 3072) or not bool(torch.isfinite(signal).all()):
        raise AssertionError(f"v1 ancestral batch: {tuple(signal.shape)}, finite "
                             f"{bool(torch.isfinite(signal).all())}")
    anc.update(windows_per_s=V1_BATCH / anc["seconds"],
               host_ms_per_step=anc["seconds"] * 1e3 / V1_TIMESTEPS,
               latent_std=float(z.std()), signal_std=float(signal.std()))
    say("v2", encoder_seconds=f"{out['train_v1_encoder']['seconds']:.2f}",
        best_l1=f"{best:.5f}", ddpm_seconds=f"{out['train_v1_ddpm']['seconds']:.2f}",
        ddpm_loss=f"{log[-1]['loss']:.5f}", ancestral_seconds=f"{anc['seconds']:.2f}",
        windows_per_s=f"{anc['windows_per_s']:.3f}",
        host_ms_per_step=f"{anc['host_ms_per_step']:.3f}", relayouts=anc["relayouts"],
        peak_gib=",".join(f"{out[k]['peak_bytes'] / 2**30:.2f}" for k in
                          ("train_v1_encoder", "train_v1_ddpm", "ancestral")),
        **{f"{k}_launches": out[k]["launches"] for k in out})

    x, eps = v1_encoder_inputs(SEED + 91)
    enc_state = V.init_v1_encoder_state(v1_aekl(), DiscriminatorV1(), SEED, device="cuda")
    out["encoder_step"] = step_timing("v2-encoder-step",
                                      V.make_v1_encoder_train_step(enc_state), (x, eps))
    opt = torch.optim.Adam(unet.parameters(), lr=2.5e-5)
    gen = C.make_generator(SEED, "cuda", C.V1_DDPM_STREAM, 0)
    out["ddpm_step"] = step_timing(
        "v2-ddpm-step", V.make_v1_ddpm_train_step(tbl, unet, ae, opt),
        (x, *V.draw_v1_ddpm_inputs(gen, V1_BATCH, V1_LATENT, V1_TIMESTEPS)))
    unet.eval()
    zt = torch.randn((V1_BATCH, *V1_LATENT), device="cuda")
    t = torch.full((V1_BATCH,), 500, dtype=torch.long, device="cuda")

    def sample_step(z, tt):
        with torch.inference_mode():
            return p_sample(tbl, unet, z, tt, torch.randn_like(z))

    out["sample_step"] = step_timing("v2-ancestral-step", sample_step, (zt, t))
    for k in ("encoder_step", "ddpm_step", "sample_step"):
        out[k]["windows_per_s"] = V1_BATCH / out[k]["host_ms"] * 1e3
    del ae, unet, opt, enc_state, x, eps
    free_card()
    return out


def hold_quant_layers(unet: UNet1d, x: torch.Tensor, t: torch.Tensor) -> dict:
    """Every ``QuantConv1d`` of one forward of the int8 ``unet`` on the card
    against a CPU copy of the same layer on the card's own input: the int8
    activations and the int32 accumulators equal, the output within fp32
    rounding (rtol 1e-6 / atol 1e-6). Returns the layers held and the
    largest output error."""
    seen = []

    def record(mod, args, out):
        seen.append((mod, args[0].clone(), out.clone()))

    hooks = [m.register_forward_hook(record) for m in unet.modules()
             if isinstance(m, QuantConv1d)]
    with torch.inference_mode():
        unet(x, t)
    for h in hooks:
        h.remove()
    worst = 0.0
    with torch.inference_mode():
        for mod, inp, out in seen:
            cpu = copy.deepcopy(mod).cpu()
            (xq, _), (xq_cpu, _) = act_quantize(inp), act_quantize(inp.cpu())
            acc = int8_conv_accumulate(xq, mod.matrix(), mod.kernel, mod.out_channels)
            acc_cpu = int8_conv_accumulate(xq_cpu, cpu.matrix(), cpu.kernel, cpu.out_channels)
            if not (torch.equal(xq.cpu(), xq_cpu) and torch.equal(acc.cpu(), acc_cpu)):
                raise AssertionError(f"int8 layer {tuple(mod.weight_q.shape)}: int8 inputs or "
                                     "int32 accumulators differ from the CPU's")
            want = cpu(inp.cpu())
            torch.testing.assert_close(out.cpu(), want, rtol=1e-6, atol=1e-6)
            worst = max(worst, float((out.cpu() - want).abs().max()))
    if not seen:
        raise AssertionError("the int8 UNet ran no QuantConv1d")
    return dict(layers=len(seen), max_abs_err=worst)


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def quant_batch(cfg: Config, unet_sd, ae_sd, tmp: Path, i: int, quantized: bool) -> dict:
    """One batch of 64 seeds through ``sample_ldm_trials`` (the entry point,
    model build and artifacts included), bf16 or int8: seconds, counts,
    shapes and the signals."""
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / f"q_{quantized}_{i}", i * BATCH,
                            (i + 1) * BATCH, BATCH, compute_psd=False, quantized=quantized)
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0, counts=read_counts(), shapes=read_shapes(),
                signals=sig)


def phase_quant(tmp: Path) -> dict:
    """Q1: the int8 sampler. Tiny (the tiny sampler's widths, fp32): every
    ``QuantConv1d`` of one int8 UNet forward on the card against the same
    layer on the CPU, on the card's own input (``hold_quant_layers``); then
    ``sample_ldm_trials(quantized=True)`` at DDIM-4 on the card, K1
    launches as derived and none of K2, finite. The card's and the CPU's
    int8 outputs are not held to each other: a rounding's difference in
    one activation moves its int8 value by a whole step, and the UNet's
    chain of quantized layers carries that on, at times about as far as
    int8 itself moves the output; their distances are reported. Then the
    flagship configuration (ldm.yaml's UNet and aekl_eeg.yaml's AEKL, bf16,
    seeded weights) at batch 64, DDIM-200: one int8 warm-up batch, then bf16, int8, int8, bf16
    batches on the same seeds, each one call of the entry point: seconds,
    windows/s, K1 and K2 launches (int8: K1 at every GroupNorm, no K2), and
    the int8 signals against the bf16 ones (relative L2); then one int8 DDIM
    step on the host clock (median of five) and under torch.profiler
    (device ms by kernel, busy share)."""
    cfg = tiny_config(steps=4)
    unet_sd, ae_sd = seeded_weights(cfg, SEED + 110)
    x = torch.from_numpy(np.random.default_rng(SEED + 111).standard_normal(
        (4, 1, cfg.unet.image_size)).astype(np.float32))
    unet, _ = build_models(cfg, unet_sd, ae_sd, torch.device("cuda"), quantized=True)
    layers = hold_quant_layers(unet, x.cuda(), torch.tensor([10, 200, 500, 900], device="cuda"))
    kw = dict(start_seed=0, stop_seed=4, batch_size=4, compute_psd=False)
    card, counts, _ = counted("tiny int8 sampler", quant_launches(cfg, 4, 1),
                              lambda: sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3,
                                                        tmp / "q_tiny_card", device="cuda",
                                                        quantized=True, **kw))
    if card.shape != (4, 4 * cfg.unet.image_size - 72, 1) or not np.isfinite(card).all():
        raise AssertionError(f"tiny int8 sampler: output {card.shape}")
    cpu = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "q_tiny_cpu", device="cpu",
                            quantized=True, **kw)
    cpu_fp = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "q_tiny_fp", device="cpu", **kw)
    out = dict(tiny_layers=layers, tiny_rel_l2_to_cpu_int8=rel_l2(card, cpu),
               tiny_rel_l2_to_cpu_fp32=rel_l2(card, cpu_fp),
               cpu_int8_rel_l2_to_fp32=rel_l2(cpu, cpu_fp), tiny_launches=counts)
    say("q1-tiny", layers=layers["layers"], layer_max_abs_err=f"{layers['max_abs_err']:.3e}",
        **{k: f"{v:.3e}" for k, v in out.items() if "rel_l2" in k},
        k1_launches=counts["K1"], k2_launches=counts["K2"])

    cfg = flagship_config(steps=STEPS)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    want = {True: quant_launches(cfg, STEPS, 1), False: expected_launches(cfg, STEPS, 1)}
    quant_batch(cfg, unet_sd, ae_sd, tmp, 0, True)
    runs = {True: [], False: []}
    for quantized in (False, True, True, False):
        r = quant_batch(cfg, unet_sd, ae_sd, tmp, 1, quantized)
        if r["counts"] != {**want[quantized], "K3": 0}:
            raise AssertionError(f"{'int8' if quantized else 'bf16'} batch: launches "
                                 f"{r['counts']}, expected {want[quantized]}")
        if r["signals"].shape != (BATCH, 3000, 1) or not np.isfinite(r["signals"]).all():
            raise AssertionError(f"int8 phase: signals {r['signals'].shape}")
        runs[quantized].append(r)
    rel = rel_l2(runs[True][0]["signals"], runs[False][0]["signals"])
    for quantized, name in ((True, "int8"), (False, "bf16")):
        s = [r["seconds"] for r in runs[quantized]]
        out[name] = dict(seconds=s, windows_per_s=BATCH / statistics.median(s),
                         launches=runs[quantized][0]["counts"])
    out.update(int8_vs_bf16_rel_l2=rel, shapes=runs[True][0]["shapes"])
    unet, _ = build_models(cfg, unet_sd, ae_sd, torch.device("cuda"), quantized=True)
    sched = sampling_schedule(cfg, "cuda")
    x = torch.randn((BATCH, 1, cfg.unet.image_size), device="cuda")
    with torch.inference_mode():
        ddim_sample_loop(unet, sched, x, 2)
        step_ms = statistics.median(host_ms(lambda: ddim_sample_loop(unet, sched, x, 1), 5))
        _, device_ms, top, n_kernels = device_profile(
            lambda: ddim_sample_loop(unet, sched, x, 1), 5)
    out["int8_step"] = dict(host_ms=step_ms, device_ms=device_ms,
                            busy_share=device_ms / step_ms, top=top, kernels=n_kernels)
    say("q1-step", host_ms=f"{step_ms:.3f}", device_ms=f"{device_ms:.3f}",
        busy_share=f"{device_ms / step_ms:.3f}", kernels=n_kernels)
    for row in top[:8]:
        say("q1-step-top", ms_per_step=f"{row['ms_per_run']:.3f}", kernel=row["kernel"][:80])
    del unet, x
    say("q1", int8_windows_per_s=f"{out['int8']['windows_per_s']:.2f}",
        bf16_windows_per_s=f"{out['bf16']['windows_per_s']:.2f}",
        int8_seconds=[f"{v:.3f}" for v in out["int8"]["seconds"]],
        bf16_seconds=[f"{v:.3f}" for v in out["bf16"]["seconds"]],
        int8_vs_bf16_rel_l2=f"{rel:.4f}", int8_k1=out["int8"]["launches"]["K1"],
        int8_k2=out["int8"]["launches"]["K2"])
    free_card()
    return out


def phase_long_window() -> dict:
    """W1: the long window (``benches/long_window.py``: the default UNet on
    windows of 12288, batch 16, bf16, DDIM-50 over the LDM's sampling
    schedule, seeded weights). A ``kv_block_size`` of 1000, which does not
    divide the 3072 attention tokens, is refused with JAX's AssertionError
    before any kernel is launched. Then blocks 512 and 0, each after a
    two-step warm-up: seconds, ms per step, windows/s, peak memory, launch
    counts as derived; the two outputs must be equal (the block changes
    only the refusal, the attention stays one SDPA call)."""
    bad, sched, x_T = long_window_inputs(long_window_config(LONG_BAD_BLOCK))
    profiling.reset()
    try:
        with torch.inference_mode():
            ddim_sample_loop(bad, sched, x_T, 1)
    except AssertionError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"kv_block_size {LONG_BAD_BLOCK} was not refused")
    torch.cuda.synchronize()
    if read_counts() != {"K1": 0, "K2": 0, "K3": 0} or "L=3072" not in refusal:
        raise AssertionError(f"the refusal launched {read_counts()}: {refusal}")
    say("w1-refusal", block=LONG_BAD_BLOCK, message=refusal[:60].replace(" ", "_"))
    del bad
    out, outputs = dict(refusal=refusal), {}
    for block in (LONG_BLOCK, 0):
        unet, sched, x_T = long_window_inputs(long_window_config(block))
        with torch.inference_mode():
            ddim_sample_loop(unet, sched, x_T, 2)
            free_card()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            x, counts, shapes = counted(f"long window, block {block}",
                                        times(unet_launches(unet), LONG_STEPS),
                                        lambda: ddim_sample_loop(unet, sched, x_T, LONG_STEPS))
            seconds = time.perf_counter() - t0
        outputs[block] = x
        out[f"block_{block}"] = dict(seconds=seconds, ms_per_step=seconds * 1e3 / LONG_STEPS,
                                     windows_per_s=LONG_BATCH / seconds, launches=counts,
                                     peak_bytes=torch.cuda.max_memory_allocated())
        out["shapes"] = shapes
        del unet
    if not torch.equal(outputs[LONG_BLOCK], outputs[0]) or not bool(
            torch.isfinite(outputs[0]).all()):
        raise AssertionError("long window: blocks 512 and 0 differ, max |diff| "
                             f"{float((outputs[LONG_BLOCK] - outputs[0]).abs().max())}")
    for block in (LONG_BLOCK, 0):
        r = out[f"block_{block}"]
        say("w1", block=block, seconds=f"{r['seconds']:.3f}", ms_per_step=f"{r['ms_per_step']:.3f}",
            windows_per_s=f"{r['windows_per_s']:.3f}", peak_gib=f"{r['peak_bytes'] / 2**30:.2f}",
            k1_launches=r["launches"]["K1"], k2_launches=r["launches"]["K2"])
    del outputs
    free_card()
    return out


# -- the options variant (OPT) and data parallelism (MESH) ---------------------

# ldm.yaml's UNet and aekl_eeg.yaml's AEKL with every option the JAX package
# can set: scale-shift norm, resampling outside the resblocks (a stride-2
# conv down, nearest + conv up), dropout (inert, as in the JAX trainers), and
# attention in the AEKL's last level and both non-local blocks.
OPT_UNET = dict(use_scale_shift_norm=True, resblock_updown=False, conv_resample=True,
                dropout=0.1)
OPT_AEKL = dict(attention_levels=[False, False, True], with_encoder_nonlocal_attn=True,
                with_decoder_nonlocal_attn=True)
OPT_TIMED_STEPS = 3  # timed training steps after the counted one
TRAIN_PATHS = ("train step", "stage-1 step", "DM train step", "options stage-2 step",
               "attention stage-1 step")
MESH_TRAIN_BATCH, MESH_STAGE1_BATCH, MESH_TIMED = 256, 512, 5


def with_options(cfg: Config) -> Config:
    for k, v in OPT_UNET.items():
        setattr(cfg.unet, k, v)
    for k, v in OPT_AEKL.items():
        setattr(cfg.aekl, k, v)
    return cfg


def meta_models(cfg: Config) -> tuple:
    lc = cfg.aekl.latent_channels
    with torch.device("meta"):
        return build_unet(cfg, lc, lc), build_aekl(cfg)


def module_launches(cfg: Config, forwards: int = 0, decodes: int = 0,
                    train_steps: int = 0, stage1_steps: int = 0) -> dict:
    """Launches derived from the models' modules: a sampler's UNet forwards
    (``unet_launches``) and decodes (K1 at every decoder GroupNorm, the
    attention norms included); a stage-2 step K1 at every UNet and encoder
    GroupNorm, K3 at the UNet's; a stage-1 step K1 and K3 at every AEKL
    GroupNorm."""
    unet, ae = meta_models(cfg)
    u, enc, dec = (n_modules(m, GroupNorm32) for m in (unet, ae.encoder, ae.decoder))
    out = times(unet_launches(unet), forwards,
                {"K1": decodes * dec + train_steps * (u + enc) + stage1_steps * (enc + dec),
                 "K3": train_steps * u + stage1_steps * (enc + dec)})
    return out


def aekl_jax_layout(run: dict) -> dict:
    """A ``tiny_stage1_run`` record with the AEKL's leaves in the JAX tree's
    layout: each attention's to_q, to_k and to_v fused into one qkv leaf,
    as JAX holds them (the k bias alone has only a rounding's gradient,
    softmax ignoring a shift of k)."""
    def convert(d: dict) -> dict:
        ae = {k[len("ae."):]: v for k, v in d.items() if k.startswith("ae.")}
        return {**flat(aekl_state_to_jax(ae), "ae"),
                **{k: v for k, v in d.items() if not k.startswith("ae.")}}

    return dict(run, grads=[convert(g) for g in run["grads"]], before=convert(run["before"]),
                after=convert(run["after"]))


def tiny_options_config() -> Config:
    cfg = with_options(tiny_stage1_config())
    return cfg


def opt_tiny(tmp: Path) -> dict:
    """The options variant tiny (the tiny sampler's widths, fp32), card
    against CPU: a 4-step DDIM sampler plus decode at the model bound; one
    stage-2 step (loss at the model bound, each gradient within 2e-3 of its
    leaf's largest); one stage-1 step held by ``hold_tiny_stage1``. Launch
    counts as derived from the modules."""
    cfg = tiny_options_config()
    unet_sd, ae_sd = seeded_weights(cfg, SEED + 120)
    kw = dict(start_seed=0, stop_seed=4, batch_size=4, compute_psd=False)
    card, counts, _ = counted("tiny options sampler", module_launches(cfg, forwards=4, decodes=1),
                              lambda: sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3,
                                                        tmp / "opt_tiny_card", device="cuda",
                                                        **kw))
    cpu = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.3, tmp / "opt_tiny_cpu", device="cpu", **kw)
    np.testing.assert_allclose(card, cpu, rtol=2e-3, atol=2e-4,
                               err_msg="tiny options sampler: card vs CPU")
    out = dict(sampler_max_abs_err=float(np.abs(card - cpu).max()), sampler_launches=counts)

    rng = np.random.default_rng(SEED + 121)
    b, lat = 4, (1, cfg.unet.image_size)
    x = rng.uniform(size=(b, 1, 4 * lat[1])).astype(np.float32)
    t, noise, enc = (rng.integers(0, 1000, b), rng.standard_normal((b, *lat)).astype(np.float32),
                     rng.standard_normal((b, *lat)).astype(np.float32))
    runs = {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            unet = load_numpy_state(build_unet(cfg, 1, 1), unet_sd)
            ae = load_numpy_state(build_aekl(cfg), ae_sd).requires_grad_(False)
        opt = torch.optim.Adam(unet.parameters(), lr=1e-4)
        step = T.make_ldm_train_step(unet, ae, T.make_schedule(cfg, dev), opt, 1.1)
        args = [torch.from_numpy(a).to(dev) for a in (x, t, noise, enc)]
        loss, c, _ = counted(f"tiny options stage-2 step on {dev}",
                             module_launches(cfg, train_steps=1) if dev == "cuda"
                             else {"K1": 0, "K2": 0, "K3": 0}, lambda: step(*args))
        runs[dev] = (float(loss), {k: host_copy(v.grad) for k, v in unet.named_parameters()})
    (card_loss, card_g), (cpu_loss, cpu_g) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=2e-3, atol=2e-4,
                               err_msg="tiny options stage-2 loss: card vs CPU")
    ratio = 0.0
    for k, g in cpu_g.items():
        top, err = float(np.abs(g).max()), float(np.abs(card_g[k] - g).max())
        if not (top > 0 and err <= 2e-3 * top):
            raise AssertionError(f"tiny options stage-2 gradient {k}: |err| {err:.3e}, "
                                 f"leaf's largest {top:.3e}")
        ratio = max(ratio, err / top)
    out.update(stage2_loss=card_loss, stage2_loss_err=abs(card_loss - cpu_loss),
               stage2_grad_err_ratio=ratio)

    x = rng.uniform(size=(b, 1, 4 * lat[1])).astype(np.float32)
    eps = [rng.standard_normal((b, 1, lat[1])).astype(np.float32)]
    # seeded AEKL weights: the trainer's zero output projections would leave
    # every q, k and v gradient of a first step at 0
    card_s1, c1, _ = counted("tiny attention stage-1 step", module_launches(cfg, stage1_steps=1),
                             lambda: tiny_stage1_run(cfg, "cuda", x, eps, ae_sd))
    held = hold_tiny_stage1(aekl_jax_layout(card_s1),
                            aekl_jax_layout(tiny_stage1_run(cfg, "cpu", x, eps, ae_sd)),
                            what="tiny attention stage-1 step")
    out.update(stage1=held, stage1_launches=c1)
    say("opt-tiny", sampler_max_abs_err=f"{out['sampler_max_abs_err']:.3e}",
        stage2_loss_err=f"{out['stage2_loss_err']:.3e}",
        stage2_grad_err_ratio=f"{ratio:.3e}",
        stage1_grad_err_ratio=f"{held['grad_err_ratio']:.3e}",
        stage1_update_err_ratio=f"{held['update_err_ratio']:.3e}",
        k1=counts["K1"], k2=counts["K2"], stage1_k1=c1["K1"], stage1_k3=c1["K3"])
    return out


def timed_steps(step, args: tuple) -> dict:
    """``OPT_TIMED_STEPS`` steps after a warm-up one: median ms on the host
    clock (each ended by a synchronize) and the peak memory of the steps."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(lambda: step(*args), OPT_TIMED_STEPS)
    return dict(ms=ms, median_ms=statistics.median(ms),
                peak_bytes=torch.cuda.max_memory_allocated())


def sdpa_backends(channels: int, length: int, dtype: torch.dtype, mixed: bool) -> dict:
    """Which of SDPA's fused kernels take the q, k and v that
    ``attention.sdpa_attention`` (the attention's path under autograd, on
    the strict path and past K5's lengths) hands SDPA for one head of
    ``channels`` at ``length`` tokens (batch 4; ``mixed``: its
    mixed-precision path), the first reason each gives for refusing them
    (torch's own checks), and which would take contiguous copies of them
    (``*_contiguous``)."""
    import warnings

    seen = []
    sdpa = F.scaled_dot_product_attention

    def record(q, k, v, *args, **kwargs):
        seen.append((q, k, v))
        return sdpa(q, k, v, *args, **kwargs)

    qkv = torch.randn((4, 3 * channels, length), device="cuda").to(dtype)
    F.scaled_dot_product_attention = record
    try:
        attention.sdpa_attention(qkv, 1, mixed)
    finally:
        F.scaled_dot_product_attention = sdpa
    q, k, v = seen[0]
    out = dict(dtype=str(q.dtype), q_stride=list(q.stride()))
    for tag, args in (("", (q, k, v)), ("_contiguous", (q.contiguous(), k.contiguous(),
                                                         v.contiguous()))):
        params = torch.backends.cuda.SDPAParams(*args, None, 0.0, False, False)
        for name in ("flash", "efficient", "cudnn"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out[name + tag] = bool(getattr(torch.backends.cuda,
                                               f"can_use_{name}_attention")(params, True))
            if not tag:
                out[f"{name}_refusal"] = str(caught[0].message)[:160] if caught else ""
    return out


def opt_stage1_step(cfg: Config) -> tuple:
    """One counted stage-1 step of the attention AEKL at ``aekl_eeg.yaml``'s
    batch, halved until a step fits on the card: (batch, counts, shapes);
    ``cfg.train.batch_size`` is left at that batch."""
    batch = cfg.train.batch_size
    while True:
        cfg.train.batch_size = batch
        step = x = eps = None
        try:
            step = stage1_trainer(cfg)
            x, eps = stage1_inputs(cfg, SEED)
            metrics, counts, shapes = counted("attention stage-1 step",
                                              module_launches(cfg, stage1_steps=1),
                                              lambda: step(x, eps))
            fits = True
        except torch.OutOfMemoryError:  # freed below, once the traceback is gone
            fits = False
        step = x = eps = None
        free_card()
        if fits:
            break
        say("opt-stage1", batch=batch, out_of_memory=True)
        batch //= 2
        if batch < 64:
            raise AssertionError("the attention stage-1 step fits at no batch of 64 or more")
    values = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        raise AssertionError(f"attention stage-1 step: metrics {values}")
    require_forms("attention stage-1 step", counts, shapes["forms"])
    say("opt-stage1", batch=batch, k1_launches=counts["K1"], k3_launches=counts["K3"],
        **shapes["forms"])
    return batch, counts, shapes


def phase_opt(tmp: Path, checks: dict) -> dict:
    """OPT: the options variant (``OPT_UNET``, ``OPT_AEKL``) at full width.
    Tiny card-vs-CPU holds (``opt_tiny``); then one DDIM step of the
    sampler at batch 64, one stage-2 step at batch 1024 and one stage-1
    step of the attention AEKL at batch 2048 (halved until it fits), each
    with its launches as derived from the modules, whose new kernel shapes
    are held to the plain versions in fp32 and bf16 before anything is
    timed; then DDIM-200 batches of 64, the default sampler's beside the
    options', three of each in turns (default, options, options, default,
    default, options; seconds, median windows/s each), and each training
    step, rebuilt, after a
    warm-up step (``timed_steps``: median ms, peak memory). Returns the
    record and phase 8's rows."""
    start = time.perf_counter()
    out = dict(tiny=opt_tiny(tmp))
    out["sdpa"] = {"unet mixed bf16 (512, 192)": sdpa_backends(512, 192, torch.bfloat16, True),
                   "aekl strict fp32 (64, 768)": sdpa_backends(64, 768, torch.float32, False)}
    for where, r in out["sdpa"].items():
        say("opt-sdpa", attention=where.replace(" ", "_"), q_stride=r["q_stride"],
            **{k: r[k] for k in ("flash", "efficient", "cudnn", "flash_contiguous",
                                 "efficient_contiguous", "cudnn_contiguous")},
            efficient_refusal=r["efficient_refusal"][:100].replace(" ", "_"))
    cfg = with_options(flagship_config(steps=1))
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    _, counts, sample_shapes = counted(
        "options DDIM step", module_launches(cfg, forwards=1, decodes=1),
        lambda: sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "opt_warmup", 0, BATCH, BATCH,
                                  compute_psd=False))

    def stage2_step():
        step, _, sched, latent_shape = full_trainer(cfg, ae_sd)
        gen = C.make_generator(cfg.train.seed, "cuda", C.TRAIN_STREAM, 0)
        x = train_windows(TRAIN_BATCH, SEED)
        return step, (x, *T.draw_step_inputs(gen, TRAIN_BATCH, latent_shape,
                                             sched.num_timesteps))

    step, inputs = stage2_step()
    loss, train_counts, train_shapes = counted("options stage-2 step",
                                               module_launches(cfg, train_steps=1),
                                               lambda: step(*inputs))
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"options stage-2 step: loss {float(loss)}")
    step = inputs = loss = None
    free_card()
    s1_cfg = with_options(stage1_config())
    s1_batch, s1_counts, s1_shapes = opt_stage1_step(s1_cfg)
    check_new_shapes(checks, "options DDIM step",
                     {kid: sample_shapes[kid] for kid in ("K1", "K2")})
    check_new_shapes(checks, "options stage-2 step",
                     {kid: train_shapes[kid] for kid in ("K1", "K3")})
    check_new_shapes(checks, "attention stage-1 step",
                     {kid: s1_shapes[kid] for kid in ("K1", "K3")})

    batches = {}
    for name, c in (("default", flagship_config(steps=STEPS)),
                    ("options", with_options(flagship_config(steps=STEPS)))):
        batches[name] = (c, seeded_weights(c, SEED), module_launches(c, forwards=STEPS, decodes=1))
    sample_ldm_trials(flagship_config(steps=1), *seeded_weights(flagship_config(1), SEED), 1.0,
                      tmp / "opt_default_warmup", 0, BATCH, BATCH, compute_psd=False)
    seconds = {"default": [], "options": []}
    for name in ("default", "options", "options", "default", "default", "options"):
        c, (usd, asd), want = batches[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sig, got, shapes = counted(f"{name} DDIM-200 batch", want, lambda: sample_ldm_trials(
            c, usd, asd, 1.0, tmp / f"opt_{name}", 0, BATCH, BATCH, compute_psd=False))
        seconds[name].append(time.perf_counter() - t0)
        if sig.shape != (BATCH, 3000, 1) or not np.isfinite(sig).all():
            raise AssertionError(f"{name} DDIM-200 batch: signals {sig.shape}")
        if name == "options":
            out["sample"] = dict(launches=got, shapes=shapes)
    for name, sec in seconds.items():
        out[f"{name}_sampler"] = dict(seconds=sec, windows_per_s=BATCH / statistics.median(sec))
    ratio = out["options_sampler"]["windows_per_s"] / out["default_sampler"]["windows_per_s"]
    say("opt", options_windows_per_s=f"{out['options_sampler']['windows_per_s']:.3f}",
        default_windows_per_s=f"{out['default_sampler']['windows_per_s']:.3f}",
        options_over_default=f"{ratio:.3f}",
        k1_per_batch=out["sample"]["launches"]["K1"], k2_per_batch=out["sample"]["launches"]["K2"])

    step, inputs = stage2_step()
    step(*inputs)
    out["stage2"] = dict(batch=TRAIN_BATCH, launches=train_counts, forms=train_shapes["forms"],
                         **timed_steps(step, inputs))
    step = inputs = None
    free_card()
    step = stage1_trainer(s1_cfg)
    inputs = stage1_inputs(s1_cfg, SEED)
    step(*inputs)
    out["stage1"] = dict(batch=s1_batch, launches=s1_counts, forms=s1_shapes["forms"],
                         **timed_steps(step, inputs))
    step = inputs = None
    free_card()
    for tag in ("stage2", "stage1"):
        r = out[tag]
        say("opt", path=tag, batch=r["batch"], median_ms=f"{r['median_ms']:.2f}",
            windows_per_s=f"{r['batch'] / r['median_ms'] * 1e3:.1f}",
            peak_gib=f"{r['peak_bytes'] / 2**30:.2f}", k1=r["launches"]["K1"],
            k3=r["launches"]["K3"])
    sample = out["sample"]
    out["paths"] = {
        "K1 opt sample": ("K1", "options DDIM-200 batch", sample["shapes"]["K1"],
                          sample["launches"]["K1"]),
        "K2 opt sample": ("K2", "options DDIM-200 batch", sample["shapes"]["K2"],
                          sample["launches"]["K2"]),
        "K1 opt train": ("K1", "options stage-2 step", train_shapes["K1"], train_counts["K1"]),
        "K3 opt train": ("K3", "options stage-2 step", train_shapes["K3"], train_counts["K3"]),
        "K1 opt stage-1": ("K1", "attention stage-1 step", s1_shapes["K1"], s1_counts["K1"]),
        "K3 opt stage-1": ("K3", "attention stage-1 step", s1_shapes["K3"], s1_counts["K3"])}
    del out["sample"]["shapes"]
    free_card()
    out["seconds"] = time.perf_counter() - start
    say("opt", seconds=f"{out['seconds']:.1f}")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _equal_states(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _state(*models) -> dict:
    return {f"{i}.{k}": v.detach().clone() for i, m in enumerate(models)
            for k, v in m.state_dict().items()}


def phase_mesh(tmp: Path) -> dict:
    """MESH: ``torch.distributed`` at world size 1 over NCCL
    (``initialize_distributed`` on tcp://127.0.0.1 and a free port), cuDNN
    held to deterministic algorithms. Each path runs twice from the same
    weights and inputs, without a mesh and with ``make_mesh()`` (its
    gradient and metric all-reduces and the sampler's all-gather over one
    rank), and the two must be equal (``torch.equal``): a stage-2 step
    (flagship widths, batch 256), a stage-1 step (``aekl_eeg.yaml``, batch
    512), a DDIM-200 batch of 64 through ``sample_ldm_trials`` and a
    ``decode`` step of DeepSleepNet at batch 64. Then the two stage-2 and
    the two decode steps take turns (none, mesh, mesh, none, ...; each on
    the host clock, ended by a synchronize): the median ms the mesh adds
    per step. The process group is destroyed after."""
    from sleepgen_torch.parallel import initialize_distributed, make_mesh

    t0 = time.perf_counter()
    initialize_distributed(f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0,
                           device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        mesh = make_mesh()
        if mesh.shape != {"data": 1, "model": 1} or mesh.group is None:
            raise AssertionError(f"make_mesh(): {mesh}")
        cfg = flagship_config(steps=STEPS)
        unet_sd, ae_sd = seeded_weights(cfg, SEED)

        def stage2(m):
            unet, ae, sched, opt = T.build_trainer(cfg, ae_sd, cfg, "cuda")
            step = T.make_ldm_train_step(unet, ae, sched, opt, 1.0, DTYPES[cfg.dtype], mesh=m)
            gen = C.make_generator(cfg.train.seed, "cuda", C.TRAIN_STREAM, 0)
            args = (train_windows(MESH_TRAIN_BATCH, SEED + 130), *T.draw_step_inputs(
                gen, MESH_TRAIN_BATCH, (1, C.latent_length(cfg, 3072)), sched.num_timesteps))
            return step(*args), _state(unet), lambda: step(*args)

        def stage1(m):
            c = stage1_config()
            c.train.batch_size = MESH_STAGE1_BATCH
            ae, disc, opt_g, opt_d = A.build_trainer(c, "cuda")
            step = A.make_train_step(ae, disc, opt_g, opt_d, c, DTYPES[c.dtype], mesh=m)
            metrics = step(*stage1_inputs(c, SEED))
            return torch.stack([metrics[k] for k in sorted(metrics)]), _state(ae, disc), None

        def ddim(m):
            sig = sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "mesh_ddim", 0, BATCH, BATCH,
                                    compute_psd=False, mesh=m)
            return torch.from_numpy(sig), {}, None

        def decode(m):
            model = DeepSleepNet().cuda()
            load_numpy_state(model, flax_init_state(model, SEED))
            opt, sched = DEC.make_optimizer(model, 1e-3, 1e-3, 2, DECODE_BATCH, DECODE_BATCH)
            step = DEC.make_train_step(model, opt, sched,
                                       torch.tensor([1.0, 2.0, 0.5, 1.0, 1.5], device="cuda"),
                                       torch.Generator(device="cuda").manual_seed(SEED), m)
            gen = torch.Generator(device="cuda").manual_seed(SEED + 131)
            x = torch.randn((DECODE_BATCH, 1, 3000), generator=gen, device="cuda")
            y = torch.randint(0, 5, (DECODE_BATCH,), generator=gen, device="cuda")
            return step(x, y), _state(model), lambda: step(x, y)

        for name, fn in (("stage2", stage2), ("stage1", stage1), ("ddim", ddim),
                         ("decode", decode)):
            (a, sa, step_a), (b, sb, step_b) = fn(None), fn(mesh)
            if not (torch.equal(a, b) and _equal_states(sa, sb)) or not bool(
                    torch.isfinite(a).all()):
                raise AssertionError(f"MESH {name}: the mesh of one differs from no mesh, "
                                     f"max |diff| {float((a.float() - b.float()).abs().max())}")
            out[name] = dict(equal=True)
            if step_a is not None:
                ms = {step_a: [], step_b: []}
                for i in range(2 * MESH_TIMED):
                    turn = (step_a, step_b) if i % 2 == 0 else (step_b, step_a)
                    for f in turn:
                        ms[f] += host_ms(f, 1)
                none_ms, mesh_ms = statistics.median(ms[step_a]), statistics.median(ms[step_b])
                out[name].update(ms=none_ms, mesh_ms=mesh_ms, mesh_adds_ms=mesh_ms - none_ms)
            del a, b, sa, sb, step_a, step_b
            free_card()
            say("mesh", path=name, equal=True, **{k: f"{v:.3f}" for k, v in out[name].items()
                                                  if k != "equal"})
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.distributed.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    say("mesh", seconds=f"{out['seconds']:.1f}")
    return out


def v1_paths(shapes: dict, v1: dict | None = None) -> dict:
    """phase_timings' rows of the v1 pipeline, fp32: K1 and K3 on one
    encoder step and one DDPM step (phase 3's), K1 and K2 on one ancestral
    batch (1000 UNet forwards and the decode: phase 3's step shapes, V2's
    launches)."""
    steps = shapes["v1"]
    anc = {kid: {k: V1_TIMESTEPS * n for k, n in steps["sample_step"][1][kid].items()}
           for kid in ("K1", "K2")}
    for k, n in steps["decode"][1]["K1"].items():
        anc["K1"][k] = anc["K1"].get(k, 0) + n
    launches = v1["ancestral"]["launches"] if v1 else {kid: sum(anc[kid].values())
                                                       for kid in ("K1", "K2")}
    rows = {}
    for kid, tag in itertools.product(("K1", "K3"), ("encoder_step", "ddpm_step")):
        counts, per_shape = steps[tag]
        rows[f"{kid} v1 {tag}"] = (kid, "v1 " + tag.replace("_", " ").replace("ddpm", "DDPM"),
                                   per_shape[kid], counts[kid], torch.float32)
    for kid in ("K1", "K2"):
        rows[f"{kid} v1 ancestral"] = (kid, "v1 ancestral batch", anc[kid], launches[kid],
                                       torch.float32)
    return rows


def quant_long_paths(quant: dict, long: dict) -> dict:
    """phase_timings' rows of the int8 sampler's K1 (a DDIM-200 batch) and
    of the long window's K1 and K2 (a DDIM-50 batch), bf16, from Q1's and
    W1's runs."""
    block = long[f"block_{LONG_BLOCK}"]
    return {"K1 int8": ("K1", "int8 DDIM-200 batch", quant["shapes"]["K1"],
                        quant["int8"]["launches"]["K1"]),
            **{f"{kid} long": (kid, "long-window DDIM-50 batch", long["shapes"][kid],
                               block["launches"][kid]) for kid in ("K1", "K2")}}


def phase_dit_step() -> tuple:
    """One full-width DiT-XL/2 forward as a guided DPM++ step of 64 windows
    runs it (``DiTConfig``'s widths, 5 stages and the null class, bf16, the
    64 rows of stage 2 beside their 64 null-label rows, inference mode):
    K4's launches, counted from zero just before, must be its 2 depth + 1
    passes, the forward's output finite. Returns K4's shapes on that path
    ({(B, T, D, form): launches}, derived from the configuration) and the
    launches."""
    d = DiTConfig(num_classes=SERVE_CLASSES)
    torch.manual_seed(SEED)
    with torch.device("cuda"):
        model = DiT1d(in_channels=1, input_size=d.input_size, patch_size=d.patch_size,
                      hidden_size=d.hidden_size, depth=d.depth, num_heads=d.num_heads,
                      mlp_ratio=d.mlp_ratio, num_classes=d.num_classes)
    model = cast_compute_dtype(model.eval(), torch.bfloat16).requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((2 * BATCH, 1, d.input_size), generator=gen, device="cuda")
    t = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda").repeat(2)
    y = torch.tensor([SERVE_STAGE] * BATCH + [-1] * BATCH, device="cuda")
    profiling.reset()
    with torch.inference_mode():
        out = model(x, t, y)
    torch.cuda.synchronize()
    launches, want = profiling.counters()["k4.launches"], 2 * d.depth + 1
    if launches != want or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{DIT_PATH}: K4 launches {launches}, expected {want}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    rows, tokens = 2 * BATCH, d.input_size // d.patch_size
    shapes = {(rows, tokens, d.hidden_size, "first"): 1,
              (rows, tokens, d.hidden_size, "residual"): 2 * d.depth - 1,
              (rows, tokens, d.hidden_size, "final"): 1}
    say("dit-step", rows=rows, tokens=tokens, hidden=d.hidden_size, depth=d.depth,
        k4_launches=launches)
    del model, x, out
    free_card()
    return shapes, launches


def check_new_shapes(checks: dict, path: str, shapes: dict) -> None:
    """Hold each kernel to its plain version at the shapes of ``shapes``
    ({kernel id: {shape: launches}}) not checked yet."""
    for kid, keys in shapes.items():
        new = [key for key in keys if key not in checks.setdefault(kid, {})]
        for key in new:
            checks[kid][key] = check_kernel(kid, key)
        free_card()
        errs = [checks[kid][key] for key in keys]
        say("check", kernel=KERNELS[kid]["name"], path=path, shapes=len(keys),
            new_shapes=len(new),
            **{k: f"{max(r[k] for r in errs):.3e}" for k in ("fp32_max_abs_err",
                                                              "bf16_max_abs_err") if k in errs[0]})


def phase_timings(paths: dict, checks: dict) -> tuple:
    """Each kernel at each shape of its path, bf16: ms of one launch, times
    its launches in one run of the path, summed. ``ms``, ``plain_ms`` and
    ``library_ms`` are eager (per call as a caller pays it);
    ``graph_ms``, ``plain_graph_ms`` and ``library_graph_ms`` the
    same calls' device time from a CUDA graph (for K3's library, an
    autograd backward, the graph holds the aten ops it runs,
    ``k3_library_ops``). ``paths`` maps a row to (kernel id, path name,
    {shape: launches in the run}, launches[, dtype]): a dtype other than
    bf16 (the reconstruction's fp32) is timed and bounded in it. Each shape
    of K1, K3 and B2 records the form its launches took (``form``, as the
    launcher reported it while it was timed), each of their rows its
    launches by form (``forms``)."""
    rows, per_shape = [], []
    timed = {}  # (kernel, shape, dtype, reps) -> its times: a shape on several paths is timed once
    form_of = {}  # (kernel, shape, dtype) -> the form K1's or K3's launcher took there
    for kid, path, shapes, launches, *dtype in paths.values():
        dtype = dtype[0] if dtype else torch.bfloat16
        spec = KERNELS[kid]
        unchecked = set(shapes) - set(checks[kid])
        if unchecked:
            raise AssertionError(f"{spec['name']} on the {path}: shapes never checked against "
                                 f"the plain version: {sorted(unchecked)}")
        names = ("ms", "plain_ms", "library_ms", "graph_ms", "plain_graph_ms",
                 "library_graph_ms", "bound_ms")
        tot = dict.fromkeys(names, 0.0)
        relayout = dict(relayout_ms=0.0, relayout_graph_ms=0.0)
        bound_kinds = set()
        forms = collections.Counter()
        for key, count in sorted(shapes.items()):
            args = spec["inputs"](key, dtype, seed=3)
            # fewer calls at the training steps' tensors of 25-400 M elements,
            # where the plain versions take milliseconds a call; 30 and 12
            # calls elsewhere keep the whole run near half its time limit
            reps = 12 if kid in ("K2", "B3") else 10 if path in TRAIN_PATHS else 30
            t = timed.get((kid, key, dtype, reps))
            if t is None:
                t = timed[kid, key, dtype, reps] = {}
                calls = dict(ms=(spec["kernel"], args), plain_ms=(spec["plain"], args),
                             library_ms=(spec["library"](*args), ()) if kid in ("K3", "K5")
                             else (spec["library"], args))
                profiling.reset()
                for name, (fn, fn_args) in calls.items():
                    t[name], t[name.replace("ms", "graph_ms")] = time_ms(
                        fn, fn_args, reps, graph=not (kid == "K3" and name == "library_ms"))
                    if name == "ms" and kid in ("K1", "K3", "B2"):
                        took = {form.split("_", 1)[1] for form in read_forms()}
                        if len(took) != 1:
                            raise AssertionError(f"{spec['name']} at {key}: forms {took}")
                        form_of[kid, key, dtype] = took.pop()
                if kid == "K3":  # autograd cannot be captured: its aten ops can
                    t["library_graph_ms"] = time_ms(k3_library_ops(*args), (), reps)[1]
            t = dict(t)
            t["bound_ms"], kind = spec["bound"](key, dtype)
            bound_kinds.add(kind)
            for k in tot:
                tot[k] = None if tot[k] is None or t[k] is None else tot[k] + t[k] * count
            if kid in ("K2", "B3"):
                # the weight re-layout, apart (made once per weight and version)
                if "relayout_ms" not in timed[kid, key, dtype, reps]:
                    timed[kid, key, dtype, reps]["relayout_ms"], timed[
                        kid, key, dtype, reps]["relayout_graph_ms"] = time_ms(
                            fused_resblock.weight_tiles, (args[3], dtype), reps)
                t.update((k, timed[kid, key, dtype, reps][k])
                         for k in ("relayout_ms", "relayout_graph_ms"))
                for k in relayout:
                    relayout[k] += t[k] * count
            form = form_of.get((kid, key, dtype))
            if form:
                forms[form] += count
            per_shape.append(dict(kernel=spec["name"], path=path, shape=list(key),
                                  launches=count, bound_by=kind, form=form, **t))
            say("time", kernel=spec["name"], path=path, shape=key, launches=count, form=form,
                **{k: "null" if v is None else f"{v:.4f}" for k, v in t.items()})
            del args
        free_card()
        if kid in ("K2", "B3"):
            say("time", kernel=spec["name"], path=path,
                **{f"{k}_per_run": f"{v:.4f}" for k, v in relayout.items()},
                kernel_ms_per_run=f"{tot['ms']:.4f}",
                kernel_graph_ms_per_run=f"{tot['graph_ms']:.4f}")
        errs = [checks[kid][key] for key in shapes]
        err_key = "fp32_max_abs_err" if dtype == torch.float32 else "bf16_max_abs_err"
        rows.append(dict(
            name=spec["name"], route="cuda", source=spec["src"], replaces=spec["replaces"],
            path=path, launches=launches, max_abs_err=max(r[err_key] for r in errs),
            bound_by="operations" if "operations" in bound_kinds else "bytes",
            **({"forms": dict(forms)} if forms else {}), **tot))
    return rows, per_shape


def time_strided_dy(strided: dict, k3_calls: int) -> dict:
    """What K3's wrapper pays to copy a strided dy to a contiguous one, per
    training step: at each (shape, dy's strides) of ``read_shapes()``'s
    ``K3_strided_dy``, ``.contiguous()`` of a bf16 tensor with those
    strides, eager and from a CUDA graph, times its calls, summed;
    ``k3_calls`` is K3's launches in the same step."""
    ms = graph_ms = 0.0
    copies = 0
    for (b, c, l, _, _, _, stride), count in strided.items():
        dy = torch.empty_strided((b, c, l), stride, dtype=torch.bfloat16, device="cuda")
        e, g = time_ms(torch.Tensor.contiguous, (dy.normal_(),), 50)
        ms, graph_ms, copies = ms + e * count, graph_ms + g * count, copies + count
        del dy
    free_card()
    say("strided-dy", copies=copies, k3_calls=k3_calls, ms_per_step=f"{ms:.4f}",
        graph_ms_per_step=f"{graph_ms:.4f}")
    return dict(copies=copies, k3_calls=k3_calls, ms=ms, graph_ms=graph_ms,
                shapes=[dict(key=list(k[:6]), stride=list(k[6]), count=v)
                        for k, v in strided.items()])


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_profile(fn, n: int) -> tuple:
    """Run fn n times under torch.profiler: (wall ms per run, device ms per
    run, top kernels by device time per run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    by_name = sorted(((_device_us(e) / 1e3 / n, e.key) for e in kernels), reverse=True)
    top = [dict(ms_per_run=ms, kernel=name[:120]) for ms, name in by_name[:12]]
    return wall_ms, sum(ms for ms, _ in by_name), top, len(kernels)


def time_psd_setup() -> dict:
    """The PSD's one-time costs: importing scipy's windows module in a
    fresh process that has numpy loaded, and solving the 3000-sample DPSS
    tapers (cache cleared before each of three solves; median)."""
    code = ("import time, numpy; t = time.perf_counter(); import scipy.signal.windows; "
            "print(time.perf_counter() - t)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True, timeout=120)
    scipy_import_ms = float(proc.stdout.strip().splitlines()[-1]) * 1e3
    solves = []
    for _ in range(3):
        dpss_tapers.cache_clear()
        t0 = time.perf_counter()
        dpss_tapers(3000)
        solves.append((time.perf_counter() - t0) * 1e3)
    return dict(scipy_import_ms=scipy_import_ms, dpss_ms=statistics.median(solves),
                dpss_ms_all=solves)


def phase_profile() -> dict:
    """Where a full-width batch's time goes: model build (as
    sample_ldm_trials does it), the PSD's one-time set-up, five DDIM
    steps (UNet forward + step, batch 64, bf16) on the host clock and then
    under torch.profiler (device time per step by kernel; busy share =
    device time / wall time), and one AEKL decode."""
    cfg = flagship_config(steps=STEPS)
    unet_sd, ae_sd = seeded_weights(cfg, SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unet, ae = build_models(cfg, unet_sd, ae_sd, torch.device("cuda"))
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    psd_setup = time_psd_setup()
    sched = sampling_schedule(cfg, "cuda")
    x = torch.randn((BATCH, 1, 768), device="cuda")
    n = 5
    with torch.inference_mode():
        ae.decode_stage_2_outputs(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ae.decode_stage_2_outputs(x)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
        ddim_sample_loop(unet, sched, x, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddim_sample_loop(unet, sched, x, n)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        _, device_ms, top, n_kernels = device_profile(lambda: ddim_sample_loop(unet, sched, x, 1),
                                                      n)
    out = dict(build_ms=build_ms, decode_ms=decode_ms, step_ms=step_ms, **psd_setup,
               device_ms_per_step=device_ms,
               busy_share=device_ms / step_ms if step_ms else 0.0, top=top)
    say("profile", build_ms=f"{build_ms:.1f}", decode_ms=f"{decode_ms:.3f}",
        scipy_import_ms=f"{psd_setup['scipy_import_ms']:.1f}",
        dpss_ms=f"{psd_setup['dpss_ms']:.1f}",
        step_ms=f"{step_ms:.3f}", device_ms_per_step=f"{device_ms:.3f}",
        busy_share=f"{out['busy_share']:.3f}", kernels=n_kernels)
    for row in top[:8]:
        say("profile-top", ms_per_step=f"{row['ms_per_run']:.3f}", kernel=row["kernel"][:80])
    return out


def profile_step(tag: str, step, inputs) -> dict:
    """One training step under torch.profiler after two warm-up steps:
    device time by kernel and the busy share."""
    for _ in range(2):
        step(*inputs)
    wall_ms, device_ms, top, n_kernels = device_profile(lambda: step(*inputs), 1)
    out = dict(step_ms=wall_ms, device_ms_per_step=device_ms, busy_share=device_ms / wall_ms,
               top=top)
    say(tag, step_ms=f"{wall_ms:.2f}", device_ms_per_step=f"{device_ms:.2f}",
        busy_share=f"{out['busy_share']:.3f}", kernels=n_kernels)
    for row in top[:10]:
        say(f"{tag}-top", ms_per_step=f"{row['ms_per_run']:.3f}", kernel=row["kernel"][:80])
    free_card()
    return out


def phase_train_profile() -> dict:
    """A full-width stage-2 training step (batch 1024, bf16), profiled."""
    cfg = flagship_config(steps=1)
    _, ae_sd = seeded_weights(cfg, SEED)
    step, _, sched, latent_shape = full_trainer(cfg, ae_sd)
    x = train_windows(TRAIN_BATCH, SEED)
    gen = C.make_generator(cfg.train.seed, "cuda", C.TRAIN_STREAM, 0)
    inputs = T.draw_step_inputs(gen, TRAIN_BATCH, latent_shape, sched.num_timesteps)
    return profile_step("profile-train", step, (x, *inputs))


def phase_stage1_profile() -> dict:
    """A full-width stage-1 step (aekl_eeg.yaml, batch 2048, bf16), profiled."""
    cfg = stage1_config()
    return profile_step("profile-stage1", stage1_trainer(cfg), stage1_inputs(cfg, SEED))


def k2_only(smi: str, build_logs: dict) -> int:
    """``--only K2``: the DDIM step that records K2's shapes and launches,
    K2's and B3's checks, then their timings per DDIM step (the step's
    measured launches at each shape); no {"ok": ...} line."""
    with tempfile.TemporaryDirectory() as td:
        shapes, checks = phase_checks(Path(td), only="K2")
    (v1_counts, v1_shapes), (long_counts, long_shapes) = shapes["v1"]["sample_step"], shapes["long"]
    rows, per_shape = phase_timings(
        {"K2": ("K2", "DDIM step", shapes["sample"]["K2"], shapes["sample_counts"]["K2"]),
         "K2 dm": ("K2", "DM DDIM step", shapes["dm_sample"]["K2"],
                   shapes["dm_sample_counts"]["K2"]),
         "K2 v1": ("K2", "v1 ancestral step", v1_shapes["K2"], v1_counts["K2"], torch.float32),
         "K2 long": ("K2", "long-window DDIM step", long_shapes["K2"], long_counts["K2"]),
         "B3": ("B3", "none", dict.fromkeys(B3_SHAPES, 1), 0)}, checks)
    for r in per_shape:  # each shape of each path: device us per call against its bound
        if r["kernel"] == KERNELS["K2"]["name"]:
            say("k2-shape", path=r["path"], shape=tuple(r["shape"]), launches=r["launches"],
                us=f"{r['graph_ms'] * 1e3:.3f}", eager_us=f"{r['ms'] * 1e3:.3f}",
                bound_us=f"{r['bound_ms'] * 1e3:.3f}",
                share_of_bound=f"{r['bound_ms'] / r['graph_ms']:.3f}")
    return write_only_report("k2", smi, build_logs, rows, per_shape, checks)


def gn_only(smi: str, build_logs: dict) -> int:
    """``--only GN``: the sampler's warm-up call (one DDIM step and the
    decode), one training step of each stage and one reconstruction batch
    record K1's and K3's shapes and launches, each count checked against
    the configuration; K1's, K3's and B2's checks; then their timings: K1
    per DDIM step (the warm-up call's measured launches, decode included),
    per training step and per reconstruction batch, K3 per
    training step, B2; and the cost of K3's strided-dy copies per step; no
    {"ok": ...} line. The attention AEKL's stage-1 step (OPT's) runs too,
    its 40 K1 and 40 K3 launches held to the cluster form and its new
    shapes checked, for its rows."""
    with tempfile.TemporaryDirectory() as td:
        shapes, checks = phase_checks(Path(td), only="GN")
    _, s1_counts, s1_shapes = opt_stage1_step(with_options(stage1_config()))
    check_new_shapes(checks, "attention stage-1 step",
                     {kid: s1_shapes[kid] for kid in ("K1", "K3")})
    step, stage1 = shapes["train_counts"], shapes["stage1_counts"]
    (quant_counts, quant_shapes), (long_counts, long_shapes) = shapes["quant_step"], shapes["long"]
    rows, per_shape = phase_timings(
        {"K1 sample": ("K1", "DDIM step", shapes["sample"]["K1"], shapes["sample_counts"]["K1"]),
         **training_paths(shapes), **recon_path(shapes), **dm_paths(shapes),
         **{k: v for k, v in v1_paths(shapes).items() if not k.startswith("K2")},
         "K1 int8": ("K1", "int8 DDIM step", quant_shapes["K1"], quant_counts["K1"]),
         "K1 long": ("K1", "long-window DDIM step", long_shapes["K1"], long_counts["K1"]),
         "K1 opt stage-1": ("K1", "attention stage-1 step", s1_shapes["K1"], s1_counts["K1"]),
         "K3 opt stage-1": ("K3", "attention stage-1 step", s1_shapes["K3"], s1_counts["K3"]),
         "B2": ("B2", "none", dict.fromkeys(B2_SHAPES, 1), 0)}, checks)
    strided = time_strided_dy(shapes["train"]["K3_strided_dy"], step["K3"])
    strided_stage1 = time_strided_dy(shapes["stage1"]["K3_strided_dy"], stage1["K3"])
    return write_only_report("gn", smi, build_logs, rows, per_shape, checks,
                             strided_dy=strided, strided_dy_stage1=strided_stage1)


def opt_only(smi: str, build_logs: dict) -> int:
    """``--only OPT``: phases OPT and MESH alone (OPT's new shapes checked
    from scratch), then the phase-8 timings of OPT's rows; no {"ok": ...}
    line."""
    checks = {kid: {} for kid in ("K1", "K2", "K3")}
    with tempfile.TemporaryDirectory() as td:
        opt = phase_opt(Path(td), checks)
        mesh = phase_mesh(Path(td))
    rows, per_shape = phase_timings(opt["paths"], checks)
    return write_only_report("opt", smi, build_logs, rows, per_shape, checks,
                             options={k: v for k, v in opt.items() if k != "paths"}, mesh=mesh)


def k4_only(smi: str, build_logs: dict) -> int:
    """``--only K4``: the DiT step that counts K4's launches, K4's checks at
    its shapes, then its timings per DiT step; no {"ok": ...} line."""
    shapes, launches = phase_dit_step()
    checks = {}
    check_new_shapes(checks, DIT_PATH, {"K4": shapes})
    rows, per_shape = phase_timings({"K4": ("K4", DIT_PATH, shapes, launches)}, checks)
    return write_only_report("k4", smi, build_logs, rows, per_shape, checks)


def k5_paths() -> dict:
    """phase_timings' rows of K5: one DDIM step of the LDM and of the DM at
    batch 64, the launches from the configurations."""
    ldm, dm = k5_shapes(flagship_config(1), BATCH), k5_shapes(dm_config(), BATCH)
    return {"K5": ("K5", "DDIM step", ldm, sum(ldm.values())),
            "K5 dm": ("K5", "DM DDIM step", dm, sum(dm.values()))}


def k5_only(smi: str, build_logs: dict) -> int:
    """``--only K5``: one DDIM step of the LDM and of the DM at batch 64,
    each of whose UNet attentions must run K5, K5's checks at their shapes,
    then its timings per step beside its bound, its plain version and SDPA
    on contiguous q, k and v; no {"ok": ...} line."""
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        cfg = flagship_config(steps=1)
        unet_sd, ae_sd = seeded_weights(cfg, SEED)
        profiling.reset()
        sample_ldm_trials(cfg, unet_sd, ae_sd, 1.0, tmp / "warmup", 0, BATCH, BATCH)
        torch.cuda.synchronize()
        require_k5("DDIM step", cfg, forwards=1)
        phase_dm_sample_step(tmp)
    paths, checks = k5_paths(), {}
    for _, path, shapes, _ in paths.values():
        check_new_shapes(checks, path, {"K5": shapes})
    rows, per_shape = phase_timings(paths, checks)
    for r in per_shape:
        say("k5-shape", path=r["path"], shape=tuple(r["shape"]), launches=r["launches"],
            us=f"{r['graph_ms'] * 1e3:.3f}", eager_us=f"{r['ms'] * 1e3:.3f}",
            bound_us=f"{r['bound_ms'] * 1e3:.3f}",
            share_of_bound=f"{r['bound_ms'] / r['graph_ms']:.3f}",
            plain_us=f"{r['plain_graph_ms'] * 1e3:.3f}",
            library_us=f"{r['library_graph_ms'] * 1e3:.3f}")
    return write_only_report("k5", smi, build_logs, rows, per_shape, checks)


def training_paths(shapes: dict) -> dict:
    """phase_timings' rows of K1 and K3 on one training step of each stage."""
    step, stage1 = shapes["train_counts"], shapes["stage1_counts"]
    return {"K1 train": ("K1", "train step", shapes["train"]["K1"], step["K1"]),
            "K1 stage1": ("K1", "stage-1 step", shapes["stage1"]["K1"], stage1["K1"]),
            "K3 train": ("K3", "train step", shapes["train"]["K3"], step["K3"]),
            "K3 stage1": ("K3", "stage-1 step", shapes["stage1"]["K3"], stage1["K3"])}


def recon_path(shapes: dict) -> dict:
    """phase_timings' row of K1 on one reconstruction batch, in fp32."""
    return {"K1 recon": ("K1", "reconstruction batch", shapes["recon"]["K1"],
                         shapes["recon_counts"]["K1"], torch.float32)}


def write_only_report(tag: str, smi: str, build_logs: dict, rows, per_shape, checks,
                      **extra) -> int:
    """An ``--only`` run's end: chiprun_out/chip_smoke_<tag>_report.json and
    the kernels' JSON line."""
    report = dict(card=smi, kernels=rows, per_shape=per_shape, build_logs=build_logs,
                  checks={kid: [dict(shape=list(k), **v) for k, v in res.items()]
                          for kid, res in checks.items()}, **extra)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"chip_smoke_{tag}_report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


def main(only: str | None = None) -> int:
    smi = phase_device()
    phase_modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_logs = phase_build()
    if only == "K2":
        return k2_only(smi, build_logs)
    if only == "GN":
        return gn_only(smi, build_logs)
    if only == "OPT":
        return opt_only(smi, build_logs)
    if only == "K4":
        return k4_only(smi, build_logs)
    if only == "K5":
        return k5_only(smi, build_logs)
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        shapes, checks = phase_checks(tmp)
        phase_tiny(tmp)
        tiny_eval = phase_tiny_eval(tmp)
        tiny_serve = phase_tiny_serve(tmp)
        full = phase_full(tmp)
        cold = phase_cold(tmp)
        tiny_train = phase_tiny_train(tmp)
        train = phase_train_full(tmp)
        tiny_stage1 = phase_tiny_stage1(tmp)
        stage1 = phase_stage1_full(tmp)
        evals = phase_eval_full(tmp)
        serve = phase_serve_full()
        serve_cli_run = phase_serve_cli(tmp)
        tiny_dm = phase_tiny_dm(tmp)
        dm = phase_dm_full(tmp)
        tiny_decode = phase_tiny_decode()
        decode = phase_decode(tmp)
        tail = phase_eval_tail(tmp, checks, Path(tiny_stage1["aekl_run_dir"]))
        tiny_v1 = phase_tiny_v1()
        v1 = phase_v1_full(tmp)
        quant = phase_quant(tmp)
        long = phase_long_window()
        opt = phase_opt(tmp, checks)
        mesh = phase_mesh(tmp)
    dit_shapes, dit_launches = phase_dit_step()
    check_new_shapes(checks, DIT_PATH, {"K4": dit_shapes})
    attention_paths = k5_paths()
    for _, path, k5_keys, _ in attention_paths.values():
        check_new_shapes(checks, path, {"K5": k5_keys})
    guided_path = "guided DPM++2M-20 request"
    check_new_shapes(checks, guided_path, {kid: serve["guided_shapes"][kid] for kid in ("K1", "K2")})
    check_new_shapes(checks, "DM DDIM-200 batch",
                     {kid: dm["sample"]["shapes"][kid] for kid in ("K1", "K2")})
    check_new_shapes(checks, "int8 DDIM-200 batch", {"K1": quant["shapes"]["K1"]})
    check_new_shapes(checks, "long-window DDIM-50 batch",
                     {kid: long["shapes"][kid] for kid in ("K1", "K2")})
    dpm = evals["dpm"]
    paths = {"K1 sample": ("K1", "sample batch", full["shapes"]["K1"], full["launches"]["K1"]),
             "K2": ("K2", "sample batch", full["shapes"]["K2"], full["launches"]["K2"]),
             **training_paths(shapes),
             "K1 dpm": ("K1", "DPM++2M-20 batch", dpm["shapes"]["K1"], dpm["launches"]["K1"]),
             "K2 dpm": ("K2", "DPM++2M-20 batch", dpm["shapes"]["K2"], dpm["launches"]["K2"]),
             **recon_path(shapes),
             "K1 guided": ("K1", guided_path, serve["guided_shapes"]["K1"],
                           serve["guided_counts"]["K1"]),
             "K2 guided": ("K2", guided_path, serve["guided_shapes"]["K2"],
                           serve["guided_counts"]["K2"]),
             **dm_paths(shapes, dm["sample"]),
             "K1 band-eval": ("K1", "band-eval reconstruction (batch 512)",
                              tail["band_shapes"]["K1"],
                              tail["band_eval"]["reconstruction_ms_ssim"]["launches"]["K1"],
                              torch.float32),
             **v1_paths(shapes, v1), **quant_long_paths(quant, long), **opt["paths"],
             "K4": ("K4", DIT_PATH, dit_shapes, dit_launches),
             **attention_paths,
             "B2": ("B2", "none", dict.fromkeys(B2_SHAPES, 1), 0),
             "B3": ("B3", "none", dict.fromkeys(B3_SHAPES, 1), 0)}
    rows, per_shape = phase_timings(paths, checks)
    strided = time_strided_dy(shapes["train"]["K3_strided_dy"], shapes["train_counts"]["K3"])
    strided_stage1 = time_strided_dy(shapes["stage1"]["K3_strided_dy"],
                                     shapes["stage1_counts"]["K3"])
    prof = phase_profile()
    train_prof = phase_train_profile()
    stage1_prof = phase_stage1_profile()
    dm_prof = phase_dm_profile()
    report = dict(card=smi, windows_per_s=full["windows_per_s"],
                  full_seconds=full["seconds"], full_median_seconds=full["median_seconds"],
                  cold=cold, batch=BATCH, steps=STEPS, train=train, tiny_train=tiny_train,
                  stage1=stage1, tiny_stage1=tiny_stage1, eval_relayouts=shapes["evals"],
                  tiny_eval=tiny_eval, eval_full={k: v for k, v in evals.items() if k != "dpm"},
                  tiny_serve=tiny_serve, serve_cli=serve_cli_run,
                  serve={k: v for k, v in serve.items() if k != "guided_shapes"},
                  dpm={k: v for k, v in dpm.items() if k != "shapes"},
                  kernels=rows, per_shape=per_shape, strided_dy=strided,
                  strided_dy_stage1=strided_stage1, profile=prof, train_profile=train_prof,
                  stage1_profile=stage1_prof, tiny_dm=tiny_dm,
                  dm={**dm, "sample": {k: v for k, v in dm["sample"].items() if k != "shapes"}},
                  dm_profile=dm_prof, tiny_decode=tiny_decode, decode=decode,
                  eval_tail={k: v for k, v in tail.items() if k != "band_shapes"},
                  tiny_v1=tiny_v1, v1=v1, quant={k: v for k, v in quant.items() if k != "shapes"},
                  long_window={k: v for k, v in long.items() if k != "shapes"},
                  options={k: v for k, v in opt.items() if k != "paths"}, mesh=mesh,
                  modules=HAVE, build_logs=build_logs,
                  checks={kid: [dict(shape=list(k), **v) for k, v in res.items()]
                          for kid, res in checks.items()})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-batch"]:
        cold_batch(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:] and sys.argv[1:] not in (["--only", "K2"], ["--only", "GN"],
                                             ["--only", "OPT"], ["--only", "K4"],
                                             ["--only", "K5"]):
        sys.exit(f"usage: {sys.argv[0]} [--only K2|GN|OPT|K4|K5]")
    sys.exit(main(only=sys.argv[2] if sys.argv[1:] else None))
