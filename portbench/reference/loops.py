"""Plain reference of the sampling loops and the stage-2 training step.

Schedules (MONAI's DDPM / DDIM semantics, betas in float64 with numpy, the
cumulative product held in float32), the deterministic DDIM loop, the
DPM-Solver++(2M) loop (Lu et al. 2022, multistep data prediction, timesteps
uniform in log-SNR), the per-seed initial noise, the crop of the border
pad, the stage-2 loss and Adam (Kingma and Ba 2015, torch's defaults).
Written from those descriptions; imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

BORDER_PAD = 36  # 3072-sample windows cropped to the 3000 of a 30 s epoch at 100 Hz


def alphas_cumprod(schedule: str, steps: int, start: float, end: float) -> np.ndarray:
    """float32 cumulative product of 1 - beta for "linear_beta" or
    "scaled_linear_beta" (linspace in sqrt space, squared)."""
    if schedule == "linear_beta":
        betas = np.linspace(start, end, steps, dtype=np.float64)
    elif schedule == "scaled_linear_beta":
        betas = np.linspace(start ** 0.5, end ** 0.5, steps, dtype=np.float64) ** 2
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return np.cumprod(1.0 - betas).astype(np.float32)


def seed_noise(seeds: Sequence[int], channels: int, length: int) -> torch.Tensor:
    """(B, C, L) fp32 standard normal noise on the CPU: for each seed, a CPU
    generator seeded with it draws (L, C)."""
    return torch.stack([torch.randn((length, channels),
                                    generator=torch.Generator().manual_seed(int(s)))
                        for s in seeds]).transpose(1, 2).contiguous()


def v_to_x0_eps(v, x, a):
    """v-prediction at alphas_cumprod ``a`` -> (x0, eps)."""
    sa, sb = math.sqrt(a), math.sqrt(1.0 - a)
    return sa * x - sb * v, sa * v + sb * x


def ddim(model: Callable, acp: np.ndarray, x: torch.Tensor, steps: int) -> torch.Tensor:
    """Deterministic DDIM (eta 0) from x over ``steps`` of the table ``acp``,
    for a v-predicting model."""
    ratio = len(acp) // steps
    for t in (np.arange(steps) * ratio).round()[::-1].astype(int).tolist():
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        x0, eps = v_to_x0_eps(model(x, tb), x, float(acp[t]))
        a_prev = float(acp[t - ratio]) if t - ratio >= 0 else 1.0
        x = math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps
    return x


def dpm_timesteps(acp: np.ndarray, steps: int) -> list:
    """Descending integer timesteps, uniform in log-SNR, ending at 0, a
    collision pushed one step up."""
    a = acp.astype(np.float64)
    lam = 0.5 * np.log(a) - 0.5 * np.log(1.0 - a)
    t = np.round(np.interp(np.linspace(lam[-1], lam[0], steps), lam[::-1],
                           np.arange(len(lam))[::-1])).astype(np.int64)
    t[-1] = 0
    for i in range(len(t) - 2, -1, -1):
        t[i] = max(t[i], t[i + 1] + 1)
    return t.tolist()


def dpm_pp_2m(model: Callable, acp: np.ndarray, x: torch.Tensor, steps: int) -> torch.Tensor:
    """DPM-Solver++(2M) with ``steps`` model calls for a v-predicting model;
    returns the data prediction at t = 0."""
    ts = dpm_timesteps(acp, steps)
    a = acp.astype(np.float64)
    alpha, sigma = np.sqrt(a), np.sqrt(1.0 - a)
    lam = np.log(alpha) - np.log(sigma)

    def x0_at(x, t):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        return v_to_x0_eps(model(x, tb), x, float(acp[t]))[0]

    cur = x0_at(x, ts[0])
    older, h_prev = cur, 1.0
    for i, (t, t_next) in enumerate(zip(ts[:-1], ts[1:])):
        h = float(lam[t_next] - lam[t])
        d = cur if i == 0 else (1 + h / (2 * h_prev)) * cur - h / (2 * h_prev) * older
        x = float(sigma[t_next] / sigma[t]) * x - float(alpha[t_next] * math.expm1(-h)) * d
        older, cur = cur, x0_at(x, t_next)
        h_prev = h
    return cur


def crop(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 3072) -> (B, 3000, C)."""
    return x[:, :, BORDER_PAD:-BORDER_PAD].transpose(1, 2)


def ldm_losses(unet, ae, acp_train: np.ndarray, scale_factor: float, x, t, noise, enc_eps):
    """Per-window epsilon-prediction MSE of the stage-2 step: the frozen
    encoder's posterior sample times the scale factor, noised at t."""
    with torch.no_grad():
        z = ae.posterior_sample(x, enc_eps) * scale_factor
    a = torch.as_tensor(acp_train, device=x.device)[t][:, None, None]
    noisy = a.sqrt() * z + (1.0 - a).sqrt() * noise
    return (unet(noisy, t) - noise).square().mean(dim=(1, 2))


class Adam:
    """torch.optim.Adam's update with its defaults (betas 0.9, 0.999, eps
    1e-8, bias-corrected, no weight decay) over a dict of fp32 tensors."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.p, self.lr, self.b1, self.b2, self.eps = params, lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.n = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.n += 1
        c1, c2 = 1 - self.b1 ** self.n, 1 - self.b2 ** self.n
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)
