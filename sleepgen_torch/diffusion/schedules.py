"""Noise schedules and the DDIM and DDPM transitions, in PyTorch.

Counterpart of ``sleepgen/diffusion/schedules.py`` (MONAI DDPMScheduler /
DDIMScheduler semantics). Beta tables are computed in float64 with numpy,
as the reference does, and held as float32 tensors; the step math is fp32.
Table lookups take a Python int or a per-sample integer tensor and
broadcast against sample batches of shape (B, ...); the DDIM and DDPM
steps take the sampler loops' scalar timesteps. ``ddim_update`` is the
DDIM step at given alphas_cumprod values, which ``ddim_tables`` holds per
step of a loop on the device, so that one step's code serves every step.

Noise of the ancestral loops (``Noise``): a ``torch.Generator`` on x's
device, from which each draw is one standard normal of x's shape in the
order the loop documents, or an iterator of tensors given in that same
order (the parity tests feed it the JAX package's threefry draws, which
torch cannot reproduce).
"""
from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np
import torch

PREDICTION_TYPES = ("epsilon", "sample", "v_prediction")

Noise = Union[torch.Generator, Iterator[torch.Tensor]]


def draw_noise(noise: Noise, like: torch.Tensor) -> torch.Tensor:
    """The next standard normal draw of ``like``'s shape, fp32 on its device."""
    if isinstance(noise, torch.Generator):
        return torch.randn(like.shape, generator=noise, device=like.device)
    return next(noise).to(device=like.device, dtype=torch.float32)


def make_betas(schedule: str, num_timesteps: int, beta_start: float = 1e-4,
               beta_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta table (float64). "linear_beta"/"linear" is MONAI's plain
    linspace; "scaled_linear_beta"/"scaled_linear"/"ldm_linear" is the
    sqrt-space linspace squared."""
    t = np.float64
    if schedule in ("linear_beta", "linear", "sqrt_linear"):
        betas = np.linspace(beta_start, beta_end, num_timesteps, dtype=t)
    elif schedule in ("scaled_linear_beta", "scaled_linear", "ldm_linear"):
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps, dtype=t) ** 2
    elif schedule == "cosine":
        steps = np.arange(num_timesteps + 1, dtype=t) / num_timesteps + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt":
        betas = np.linspace(beta_start, beta_end, num_timesteps, dtype=t) ** 0.5
    elif schedule == "sigmoid_beta":
        sig = 1 / (1 + np.exp(-np.linspace(-6, 6, num_timesteps, dtype=t)))
        betas = sig * (beta_end - beta_start) + beta_start
    else:
        raise ValueError(f"unknown beta schedule '{schedule}'")
    return betas


class NoiseSchedule:
    """Schedule tables (fp32, on one device) and the conversions every
    sampler needs."""

    def __init__(self, betas: np.ndarray, prediction_type: str = "epsilon",
                 device: torch.device | str = "cpu"):
        if prediction_type not in PREDICTION_TYPES:
            raise ValueError(f"unknown prediction_type '{prediction_type}'")
        self.num_timesteps = int(len(betas))
        self.prediction_type = prediction_type
        self.betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
        acp = np.cumprod(1.0 - betas).astype(np.float32)
        self.alphas_cumprod = torch.as_tensor(acp, device=device)
        # The same fp32 table on the host, for loops that compute per-step
        # scalars: reading the device table back would wait for the card.
        self.alphas_cumprod_host = acp
        self._ddim_tables = {}

    @classmethod
    def create(cls, schedule: str = "linear_beta", num_timesteps: int = 1000,
               beta_start: float = 1e-4, beta_end: float = 2e-2,
               prediction_type: str = "epsilon",
               device: torch.device | str = "cpu") -> "NoiseSchedule":
        return cls(make_betas(schedule, num_timesteps, beta_start, beta_end),
                   prediction_type, device)

    def _gather(self, table: torch.Tensor, t, ndim: int) -> torch.Tensor:
        """table[t] broadcast to an ndim-rank sample batch. A Python int
        indexes without a host-to-device copy (which would wait for the
        card once per sampler step)."""
        out = table[t] if isinstance(t, int) else table[torch.as_tensor(t, device=table.device)]
        return out.reshape(out.shape + (1,) * (ndim - out.dim()))

    def sqrt_acp(self, t, ndim: int) -> torch.Tensor:
        return torch.sqrt(self._gather(self.alphas_cumprod, t, ndim))

    def sqrt_one_minus_acp(self, t, ndim: int) -> torch.Tensor:
        return torch.sqrt(1.0 - self._gather(self.alphas_cumprod, t, ndim))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """q(x_t | x_0): sqrt(acp_t) x0 + sqrt(1 - acp_t) eps."""
        return self.sqrt_acp(t, x0.dim()) * x0 + self.sqrt_one_minus_acp(t, x0.dim()) * noise

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """v = sqrt(acp_t) eps - sqrt(1 - acp_t) x0."""
        return self.sqrt_acp(t, x0.dim()) * noise - self.sqrt_one_minus_acp(t, x0.dim()) * x0

    def to_x0_eps(self, model_out: torch.Tensor, x_t: torch.Tensor,
                  t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Network output under this schedule's prediction type ->
        (pred_x0, pred_eps)."""
        return self.x0_eps(model_out, x_t, self._gather(self.alphas_cumprod, t, x_t.dim()))

    def x0_eps(self, model_out: torch.Tensor, x_t: torch.Tensor,
               acp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``to_x0_eps`` at the alphas_cumprod value ``acp``, shaped to
        broadcast against x_t."""
        sa = torch.sqrt(acp)
        sb = torch.sqrt(1.0 - acp)
        if self.prediction_type == "epsilon":
            return (x_t - sb * model_out) / sa, model_out
        if self.prediction_type == "sample":
            return model_out, (x_t - sa * model_out) / sb
        return sa * x_t - sb * model_out, sa * model_out + sb * x_t


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Descending inference timesteps (MONAI set_timesteps)."""
    ratio = num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * ratio).round()[::-1].copy().astype(np.int32)


def ddim_step(sched: NoiseSchedule, model_out: torch.Tensor, t: int, t_prev: int,
              x_t: torch.Tensor, eta: float = 0.0, clip_sample: bool = False,
              noise: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM step x_t -> x_{t_prev} at scalar timesteps; returns
    (x_prev, pred_x0). A negative t_prev (the last step) uses acp_prev = 1."""
    ndim = x_t.dim()
    acp_t = sched._gather(sched.alphas_cumprod, t, ndim)
    acp_prev = (sched._gather(sched.alphas_cumprod, t_prev, ndim) if t_prev >= 0
                else torch.ones_like(acp_t))
    return ddim_update(sched, model_out, x_t, acp_t, acp_prev, eta, clip_sample, noise)


def ddim_update(sched: NoiseSchedule, model_out: torch.Tensor, x_t: torch.Tensor,
                acp_t: torch.Tensor, acp_prev: torch.Tensor, eta: float = 0.0,
                clip_sample: bool = False, noise: torch.Tensor | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ddim_step`` at the alphas_cumprod values of t and t_prev, each
    shaped to broadcast against x_t; returns (x_prev, pred_x0)."""
    x0, eps = sched.x0_eps(model_out, x_t, acp_t)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    var = (1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)
    std = eta * torch.sqrt(var)
    x_prev = torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev - std**2) * eps
    if eta > 0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        x_prev = x_prev + std * noise
    return x_prev, x0


def ddim_tables(sched: NoiseSchedule, num_inference_steps: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The DDIM loop's steps in order, on ``device``: (timestep (int64),
    alphas_cumprod at it, at the step's t_prev) of each, the last step's
    acp_prev 1.0, as ``ddim_step`` takes it where t_prev is negative. Built
    once per schedule, step count and device from the host's copy of the
    table, so each value is the device table's."""
    key = (num_inference_steps, device)
    if key not in sched._ddim_tables:
        ts = ddim_timesteps(sched.num_timesteps, num_inference_steps).astype(np.int64)
        prev = ts - sched.num_timesteps // num_inference_steps
        acp = sched.alphas_cumprod_host
        acp_prev = np.where(prev >= 0, acp[np.maximum(prev, 0)], np.float32(1.0))
        sched._ddim_tables[key] = tuple(torch.as_tensor(a, device=device)
                                        for a in (ts, acp[ts], acp_prev.astype(np.float32)))
    return sched._ddim_tables[key]


def ddpm_step(sched: NoiseSchedule, model_out: torch.Tensor, t: int, x_t: torch.Tensor,
              noise: torch.Tensor, clip_sample: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ancestral step x_t -> x_{t-1} at a scalar timestep, with the
    fixed-small posterior variance floored at 1e-20; ``noise`` is a
    standard normal of x_t's shape, unused at t == 0. Returns
    (x_prev, pred_x0)."""
    ndim = x_t.dim()
    acp_t = sched._gather(sched.alphas_cumprod, t, ndim)
    acp_prev = (sched._gather(sched.alphas_cumprod, t - 1, ndim) if t > 0
                else torch.ones_like(acp_t))
    beta_t = sched._gather(sched.betas, t, ndim)
    x0, _ = sched.to_x0_eps(model_out, x_t, t)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    coef1 = torch.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef2 = torch.sqrt(1.0 - beta_t) * (1.0 - acp_prev) / (1.0 - acp_t)
    x_prev = coef1 * x0 + coef2 * x_t
    if t > 0:
        var = (beta_t * (1.0 - acp_prev) / (1.0 - acp_t)).clamp(min=1e-20)
        x_prev = x_prev + torch.sqrt(var) * noise
    return x_prev, x0
