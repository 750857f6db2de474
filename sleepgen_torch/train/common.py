"""What both trainers share: the random streams, the latent length and
the windows' copy to the device.

Random draws: JAX splits one threefry key per step, which torch cannot
reproduce. The port's map is its own: every draw comes from a
``torch.Generator`` on the training device, seeded from
``(cfg.train.seed, stream, ...)`` through numpy's ``SeedSequence``
(``make_generator``). Stage 2 (``train_ldm``): stream 0 is a training step
(by step number; draws the encoder's eps, then t, then the noise, then a
conditional model's label dropout), 1 an eval batch (by epoch and batch),
2 the in-training sample (by epoch; z_T, then one noise per step), 3 the
scale factor's encoder eps. Stage 1 (``train_aekl``): stream 4 is a
training step's encoder eps (by step number). The signal-space DM
(``train_dm``) uses streams 0-2 in the same roles, without the encoder's
eps. The first-generation pipeline (``train_v1``): stream 5 is a v1
encoder step's eps (by step number), 6 a v1 encoder eval batch's eps (by
epoch and batch), 7 a v1 DDPM step (by step number; draws the encoder's
eps, then t, then the noise, the JAX step's split order).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sleepgen_torch.config import Config

TRAIN_STREAM, EVAL_STREAM, SAMPLE_STREAM, SCALE_STREAM, AEKL_STREAM = 0, 1, 2, 3, 4
V1_ENCODER_STREAM, V1_EVAL_STREAM, V1_DDPM_STREAM = 5, 6, 7


def make_generator(seed: int, device: torch.device | str, *stream: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, *stream)."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def latent_length(aekl_cfg: Config, length: int) -> int:
    """Latent length of a window of ``length`` samples: each of the AEKL's
    downsamplings gives ceil(L / 2)."""
    for _ in range(len(aekl_cfg.aekl.num_channels) - 1):
        length = (length + 1) // 2
    return length


def windows_to_device(batch: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(B, L, 1) numpy windows -> (B, 1, L) fp32 on ``dev``."""
    return torch.from_numpy(batch).to(dev).transpose(1, 2).contiguous()


def batch_to_device(batch, dev: torch.device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A loader's batch -> (windows (B, 1, L) fp32, labels (B,) int64 or
    None) on ``dev``: a ``WindowDataset`` yields windows, a
    ``LabeledEpochDataset`` (windows, labels)."""
    if isinstance(batch, tuple):
        x, y = batch
        return windows_to_device(x, dev), torch.from_numpy(y).long().to(dev)
    return windows_to_device(batch, dev), None


def draw_label_drop(gen: torch.Generator, batch: int, prob: float) -> Optional[torch.Tensor]:
    """(B,) bool, set where a label is dropped to the null label (with
    probability ``prob``), drawn from ``gen``; None when ``prob`` is 0."""
    if prob <= 0:
        return None
    return torch.rand((batch,), generator=gen, device=gen.device) < prob
