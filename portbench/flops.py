"""Floating-point operations of the plain reference models at a cell's
shapes, counted by ``torch.utils.flop_counter.FlopCounterMode`` on meta
tensors (a multiply-add counts two; convolutions, linear layers and the
attention's products are counted, normalisation and activations are not).
The program's own kernels launch through ctypes, where no counter sees
them, so the count comes from the reference, the same whatever runs.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import common

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16, at its 700 W limit


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def unet_forward(cfg: dict, batch: int) -> float:
    """One forward of the diffusion UNet over (batch, C, image_size)."""
    u = cfg["unet"]
    with torch.device("meta"):
        unet = common.reference_unet(cfg)
        x = torch.empty(batch, u["in_channels"], u["image_size"])
        t = torch.zeros(batch, dtype=torch.int64)
    with torch.no_grad():
        return _count(lambda: unet(x, t))


def decode(cfg: dict, batch: int) -> float:
    """One AEKL decode of (batch, latent, image_size) latents."""
    a, length = cfg["aekl"], cfg["unet"]["image_size"]
    with torch.device("meta"):
        ae = common.reference_aekl(cfg)
        z = torch.empty(batch, a["latent_channels"], length)
    with torch.no_grad():
        return _count(lambda: ae.decode(z))


def train_step(cfg: dict, batch: int) -> float:
    """One stage-2 step: the frozen encoder's forward and the UNet's forward
    and backward (no recomputation) over (batch, 1, window) windows."""
    a, u = cfg["aekl"], cfg["unet"]
    with torch.device("meta"):
        ae = common.reference_aekl(cfg)
        unet = common.reference_unet(cfg)
        x = torch.empty(batch, 1, cfg["window"])
        z = torch.empty(batch, a["latent_channels"], u["image_size"])
        t = torch.zeros(batch, dtype=torch.int64)

    def step():
        with torch.no_grad():
            ae.posterior_sample(x, torch.empty(batch, a["latent_channels"], u["image_size"],
                                               device="meta"))
        unet(z, t).square().mean().backward()

    return _count(step)
