"""Bulk DiT-MoE-XL/2-8E2A sampling: the DiT cell's driver (``sample_dit``:
``make_ldm_sampler``'s guided DPM-Solver++(2M) batches on the denoiser
``build_models`` builds, the AEKL decode and crop, each batch read back)
on the configuration's DiT with sparse experts, changed in four things
alone:

* the reference: ``reference/dit_moe.py``, built on the card;
* the weights: drawn on the card one block at a time (``weights.make_state``
  per block, purposes of this driver's own), since one draw of the
  model's 4.17B fp32 values and its scale and shift vectors would not fit;
  the program receives them as tensors, not host arrays;
* the faults: ``sample_dit``'s three (guidance off, a block skipped,
  attention unscaled) and four of the sparse layer (the second expert
  dropped, the top-2 weights renormalised, the shared experts left out,
  each slot sent to the next expert);
* the FLOP count: analytic, each token through exactly k experts
  (``forward_flops``), since a count over the reference's expert loop
  needs real routing.

Set-up refuses a program whose configuration or model has no experts
before it draws anything: a program without the sparse layer cannot run
this cell, and must not sample a dense DiT in its place.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import common, harness, weights
from portbench.reference import dit_moe as rmoe, loops, models as ref

base = harness.load_module("drivers", "sample_dit")  # this cell's own copy
SPANS = base.SPANS
# Purposes of the weights' random streams: the parameters outside the
# blocks, then block i's at WEIGHTS_DIT_MOE + 1 + i
WEIGHTS_DIT_MOE = 1000


def fault_kinds(cfg: dict) -> dict:
    """``sample_dit``'s faults and the sparse layer's four."""
    return {**base_faults(cfg), "top1": {"top_k": 1}, "renormalised": {"renormalise": True},
            "no_shared": {"no_shared": True}, "expert_shift": {"expert_shift": True}}


base_faults = base.fault_kinds


def reference_dit(cfg: dict, prec: ref.Precision | None = None, **fault) -> rmoe.DiTMoE:
    d = cfg["dit"]
    return rmoe.DiTMoE(d["in_channels"], d["input_size"], d["patch_size"], d["hidden_size"],
                       d["depth"], d["num_heads"], d["mlp_ratio"], d["num_classes"],
                       d["num_experts"], d["num_experts_per_tok"], d["n_shared_experts"],
                       d["aux_loss_alpha"], prec, **fault)


def dit_weights(cfg: dict, seed: int, device) -> dict:
    """The DiT-MoE's weights from the seed, as served (bf16 values in fp32):
    the parameters outside the blocks in one draw, each block's in its own."""
    with torch.device("meta"):
        shapes = weights.shapes_of(reference_dit(cfg))
    groups = [{k: v for k, v in shapes.items() if not k.startswith("blocks.")}]
    for i in range(cfg["dit"]["depth"]):
        groups.append({k: v for k, v in shapes.items() if k.startswith(f"blocks.{i}.")})
    state = {}
    for i, group in enumerate(groups):
        state.update(weights.make_state(group, (), seed, device, WEIGHTS_DIT_MOE + i))
    return {k: state[k] for k in shapes}


def forward_flops(cfg: dict, rows: int) -> float:
    """One forward over ``rows`` latents, counted as ``flops._count`` counts
    the reference (a multiply-add two; the patch convolution, the linear
    layers, the router and both attention products), each token through
    exactly k of the experts and the shared ones."""
    d = cfg["dit"]
    dim, depth, c, p = d["hidden_size"], d["depth"], d["in_channels"], d["patch_size"]
    tokens = d["input_size"] // p
    n = rows * tokens
    inter = int(dim * d["mlp_ratio"])
    embed = 2 * n * dim * c * p + 2 * rows * (base.rdit.FREQUENCY_EMBEDDING_SIZE * dim + dim * dim)
    adaln = 2 * rows * dim * 6 * dim * depth + 2 * rows * dim * 2 * dim
    attn = 2 * n * dim * 3 * dim + 4 * rows * tokens * tokens * dim + 2 * n * dim * dim
    moe = (2 * n * dim * d["num_experts"] + 6 * n * d["num_experts_per_tok"] * dim * inter
           + 6 * n * dim * d["n_shared_experts"] * dim)
    return float(embed + adaln + depth * (attn + moe) + 2 * n * dim * p * c)


def experts_bound(cfg: dict, slots: int) -> float:
    """Least seconds of one layer's routed experts over ``slots`` rows
    (``roofline.py``'s arithmetic: the larger of the products at the bf16
    peak and the bytes at 3.35 TB/s): gate, up and down products; the rows
    read, every expert's weights read and the output written once, the
    intermediate kept on chip."""
    from portbench import roofline

    d = cfg["dit"]
    dim, inter = d["hidden_size"], int(d["hidden_size"] * d["mlp_ratio"])
    ops = 6 * slots * dim * inter
    nbytes = 2 * (2 * slots * dim + 3 * d["num_experts"] * dim * inter)
    return max(ops / roofline.BF16_TC_OPS_PER_S, nbytes / roofline.HBM_BYTES_PER_S)


def program_models(ctx, store: list):
    """``sample_dit``'s, with the weights handed over as tensors on the card,
    after refusing a program without experts."""
    from sleepgen_torch.sample.sample_ldm import build_models

    dev = torch.device(ctx.device)
    cfg, aekl_cfg = common.program_configs(ctx.cfg)
    want = ctx.cfg["dit"]["num_experts"]
    if getattr(cfg.dit, "num_experts", 0) != want:
        raise SystemExit(f"the program's configuration has no dit.num_experts {want}: "
                         "it cannot build DiT-MoE")
    dit, ae = build_models(cfg, dit_weights(ctx.cfg, ctx.seed, dev),
                           common.aekl_weights(ctx.cfg, ctx.seed, dev), dev, aekl_cfg)
    if getattr(dit, "num_experts", 0) != want:
        raise SystemExit(f"the program built a DiT without {want} experts")
    base.sample_ldm.keep_latents(ae, store)
    return cfg, aekl_cfg, dit, ae


def reference_outputs(cfg: dict, spec: dict, seed: int, seeds, device,
                      prec: ref.Precision | None = None, fault: dict | None = None):
    """``sample_dit.reference_outputs`` with the DiT-MoE reference built on
    the device."""
    ref.set_fp32_math()
    fault = dict(fault or {})
    unguided = fault.pop("unguided", False)
    with torch.device(device):
        dit = reference_dit(cfg, prec, **fault)
    dit = common.loaded(dit, dit_weights(cfg, seed, device))
    ae = base.sample_ldm.reference_decoder(cfg, seed, device, prec)
    d = cfg["diffusion"]
    acp = loops.alphas_cumprod(d["sample_schedule"], d["timesteps"], d["sample_beta_start"],
                               d["sample_beta_end"])
    loop = base.sample_ldm.LOOPS[spec["sampler"]]
    latents = []

    def block(chunk):
        x = loops.seed_noise(chunk, cfg["aekl"]["latent_channels"],
                             cfg["dit"]["input_size"]).to(device)
        y = base.labels_of(cfg, chunk, device)
        model = (base.rdit.conditional(dit, y) if unguided
                 else base.rdit.guided(dit, y, cfg["guidance_scale"]))
        with torch.no_grad():
            z = loop(model, acp, x, spec["steps"]) / spec["scale_factor"]
            latents.append(z.cpu().numpy())
            return loops.crop(ae.decode(z)).cpu().numpy()

    windows = common.in_blocks(block, list(seeds), spec["check_block"])
    return windows, np.concatenate(latents)


for _name in ("fault_kinds", "reference_dit", "dit_weights", "forward_flops",
              "program_models", "reference_outputs"):
    setattr(base, _name, globals()[_name])
setup, window, profile, release = base.setup, base.window, base.profile, base.release
check, control, faults, numbers = base.check, base.control, base.faults, base.numbers
labels_of, decode_flops = base.labels_of, base.decode_flops
