"""Per-seed initial noise and the DDIM and DDPM reverse loops.

Counterpart of ``sleepgen/sample/samplers.py``. The loops are Python loops
over the timesteps; x stays fp32 and the model output is cast to fp32
before each step, whatever the model's compute dtype.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from sleepgen_torch.diffusion.schedules import (NoiseSchedule, ddim_step, ddim_timesteps,
                                                ddpm_step)


def seed_noise(seeds: Sequence[int], shape: Tuple[int, ...],
               device: torch.device | str) -> torch.Tensor:
    """(len(seeds), *shape) standard normal fp32 noise, one CPU
    ``torch.Generator`` per seed, then moved to ``device``.

    Each seed's noise depends on that seed alone, so a sample does not
    depend on how seeds are batched or on the device. It is not the JAX
    package's noise: that one comes from threefry ``fold_in`` of a base
    key, which torch cannot reproduce, so the two packages give different
    samples for the same seed. Parity tests hand both the same x_T."""
    noise = [torch.randn(shape, generator=torch.Generator().manual_seed(int(s)))
             for s in seeds]
    return torch.stack(noise).to(device)


def ddim_sample_loop(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     sched: NoiseSchedule, x_T: torch.Tensor,
                     num_inference_steps: int = 200, eta: float = 0.0) -> torch.Tensor:
    """Full deterministic DDIM reverse process from x_T (any layout the
    model takes); returns x_0 in fp32."""
    ratio = sched.num_timesteps // num_inference_steps
    x = x_T.float()
    for t in ddim_timesteps(sched.num_timesteps, num_inference_steps).tolist():
        t_b = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        out = model_fn(x, t_b)
        x, _ = ddim_step(sched, out.float(), t, t - ratio, x, eta=eta)
    return x


def ddpm_sample_loop(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     sched: NoiseSchedule, x_T: torch.Tensor, generator: torch.Generator,
                     clip_sample: bool = True) -> torch.Tensor:
    """Full ancestral DDPM loop over every training timestep, from x_T;
    each step's noise is drawn from ``generator`` (on x_T's device), one
    standard normal of x's shape per step, t = 0 included. Returns x_0 in
    fp32. JAX splits a threefry key instead, so the two packages draw
    different noise; parity tests inject it step by step."""
    x = x_T.float()
    for t in range(sched.num_timesteps - 1, -1, -1):
        t_b = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        out = model_fn(x, t_b)
        noise = torch.randn(x.shape, generator=generator, device=x.device)
        x, _ = ddpm_step(sched, out.float(), t, x, noise, clip_sample=clip_sample)
    return x
