"""Per-seed initial noise, the DDIM and DDPM reverse loops, and the model
closure of conditional and guided sampling.

Counterpart of ``sleepgen/sample/samplers.py``. The loops are Python loops
over the timesteps; x stays fp32 and the model output is cast to fp32
before each step, whatever the model's compute dtype. Nothing in them reads
a value back from the card, so a caller's sample runs behind the host.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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
    samples for the same seed. Parity tests hand both the same x_T.

    To a CUDA device the noise goes from pinned memory without waiting: a
    copy from pageable memory would wait for the work already queued on
    the stream, such as the previous request's sampler."""
    noise = torch.stack([torch.randn(shape, generator=torch.Generator().manual_seed(int(s)))
                         for s in seeds])
    dev = torch.device(device)
    if dev.type == "cuda":
        return noise.pin_memory().to(dev, non_blocking=True)
    return noise.to(dev)


def validate_stage(num_classes: int, stage, guidance_scale: float = 1.0) -> None:
    """Validate the arguments of conditional sampling, as the JAX package's
    ``validate_stage`` does, with the same errors for the same inputs.

    Raises ValueError when ``stage`` is missing or out of range for a
    conditional checkpoint, or when ``stage`` or ``guidance_scale`` is
    given for an unconditional one. Without the range check a negative
    stage would silently sample the guidance null branch (``UNet1d`` masks
    labels below 0 to a zero embedding) and a large one would silently
    clamp to the last class."""
    if num_classes > 0:
        if stage is None:
            raise ValueError(
                f"conditional checkpoint (num_classes={num_classes}): "
                f"pass stage=0..{num_classes - 1}")
        if not 0 <= int(stage) < num_classes:
            raise ValueError(
                f"stage {stage} out of range 0..{num_classes - 1}")
    else:
        if stage is not None:
            raise ValueError(
                "stage given but the checkpoint is unconditional "
                "(config.unet.num_classes=0)")
        if guidance_scale != 1.0:
            raise ValueError(
                "guidance_scale requires a class-conditional checkpoint "
                "(config.unet.num_classes=0 here) — it would be silently "
                "ignored")


def cond_model_fn(unet: Callable[..., torch.Tensor], labels: Optional[torch.Tensor],
                  guidance_scale: Optional[float], guided: Optional[bool] = None
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The model closure ``model_fn(x, t)`` of every sampling loop: plain
    (``labels`` None), conditional, ``unet(x, t, labels)``, or guided by
    classifier-free guidance. Counterpart of the JAX package's
    ``_cond_model_fn``.

    Guided runs one forward of the 2B batch ``[x, x]`` at ``[t, t]`` with
    the labels ``[labels, -1]`` (-1 is the null label the UNet masks), then
    returns ``v_n + s (v_c - v_n)`` in fp32: never two forwards of B.
    ``guided`` None guides when ``guidance_scale`` is not 1.0; a sampler
    whose scale is an argument of each call decides it once instead."""
    if guided is None:
        guided = guidance_scale != 1.0
    if labels is None:
        return unet
    if not guided:
        return lambda x, t: unet(x, t, labels)
    y2 = torch.cat([labels, torch.full_like(labels, -1)])

    def model_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        v_c, v_n = unet(torch.cat([x, x]), torch.cat([t, t]), y2).float().chunk(2)
        return v_n + guidance_scale * (v_c - v_n)

    return model_fn


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
