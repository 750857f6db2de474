"""The first-generation DDPM: schedule tables, loss and ancestral sampler.

Counterpart of ``sleepgen/diffusion/ddpm_v1.py`` (the reference's
``src/models/ldm.py`` DDPM wrapper, used by its first-version pipeline).
``DDPMTables`` holds every table as an fp32 tensor on one device, computed
in float64 with numpy as the JAX package computes them; ``q_sample``,
``q_posterior``, ``p_losses`` and ``p_sample`` are the same fp32 math on
(B, C, L) tensors, and ``p_sample_loop`` is a Python loop over t = T-1..0.

Kept from the JAX package on purpose:

* the schedule name "linear" is the reference's sqrt-space schedule,
  ``make_betas``' "ldm_linear" (not MONAI's plain linspace, which
  ``make_betas("linear")`` is);
* the x0-parameterisation's lvlb weights divide by (2 - acp), the
  reference's ``2.0 * 1 - acp``, and ``lvlb[0] = lvlb[1]``.

Noise of ``p_sample_loop`` is a ``schedules.Noise``: a ``torch.Generator``
on the device, or an iterator of tensors in the JAX loop's order (x_T
first, from the key split off before the loop, then one draw per step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from sleepgen_torch.diffusion.schedules import Noise, draw_noise, make_betas

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class DDPMTables:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    lvlb_weights: torch.Tensor
    logvar: torch.Tensor
    num_timesteps: int
    parameterization: str = "eps"

    @classmethod
    def create(cls, schedule: str = "ldm_linear", timesteps: int = 1000,
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3, v_posterior: float = 0.0,
               parameterization: str = "eps", logvar_init: float = 0.0,
               device: torch.device | str = "cpu") -> "DDPMTables":
        name = "ldm_linear" if schedule == "linear" else schedule
        betas = make_betas(name, timesteps, linear_start, linear_end, cosine_s)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = ((1 - v_posterior) * betas * (1.0 - acp_prev) / (1.0 - acp)
                    + v_posterior * betas)
        # post_var[0] is 0, so lvlb[0] divides by zero; it is overwritten below
        with np.errstate(divide="ignore", invalid="ignore"):
            if parameterization == "eps":
                lvlb = betas**2 / (2 * post_var * alphas * (1 - acp))
            elif parameterization == "x0":
                lvlb = 0.5 * np.sqrt(acp) / (2.0 * 1 - acp)  # the reference's bug, kept
            else:
                raise NotImplementedError(parameterization)
        lvlb[0] = lvlb[1]

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

        return cls(
            betas=f32(betas), alphas_cumprod=f32(acp), alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            lvlb_weights=f32(lvlb),
            logvar=torch.full((timesteps,), logvar_init, dtype=torch.float32, device=device),
            num_timesteps=int(timesteps), parameterization=parameterization)


def _extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = a[t]
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))


def q_sample(tbl: DDPMTables, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """A draw of q(x_t | x_0)."""
    return (_extract(tbl.sqrt_alphas_cumprod, t, x0.dim()) * x0
            + _extract(tbl.sqrt_one_minus_alphas_cumprod, t, x0.dim()) * noise)


def predict_start_from_noise(tbl: DDPMTables, x_t: torch.Tensor, t: torch.Tensor,
                             noise: torch.Tensor) -> torch.Tensor:
    return (_extract(tbl.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
            - _extract(tbl.sqrt_recipm1_alphas_cumprod, t, x_t.dim()) * noise)


def q_posterior(tbl: DDPMTables, x0: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor):
    """(mean, variance, clipped log-variance) of q(x_{t-1} | x_t, x_0)."""
    mean = (_extract(tbl.posterior_mean_coef1, t, x_t.dim()) * x0
            + _extract(tbl.posterior_mean_coef2, t, x_t.dim()) * x_t)
    var = _extract(tbl.posterior_variance, t, x_t.dim())
    logvar = _extract(tbl.posterior_log_variance_clipped, t, x_t.dim())
    return mean, var, logvar


def p_losses(tbl: DDPMTables, model_fn: ModelFn, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor, loss_type: str = "l2", l_simple_weight: float = 1.0,
             original_elbo_weight: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The DDPM training loss with per-timestep log-variance and the lvlb
    (ELBO) term: (loss, {"loss_simple", "loss_vlb", "loss"}), fp32."""
    x_noisy = q_sample(tbl, x0, t, noise)
    model_out = model_fn(x_noisy, t).float()
    target = (noise if tbl.parameterization == "eps" else x0).float()
    if loss_type == "l2":
        per = (model_out - target) ** 2
    elif loss_type == "l1":
        per = (model_out - target).abs()
    else:
        raise NotImplementedError(loss_type)
    loss_simple = per.mean(dim=tuple(range(1, per.dim())))
    logvar_t = tbl.logvar[t]
    loss = l_simple_weight * (loss_simple / torch.exp(logvar_t) + logvar_t).mean()
    loss_vlb = (tbl.lvlb_weights[t] * loss_simple).mean()
    loss = loss + original_elbo_weight * loss_vlb
    return loss, {"loss_simple": loss_simple.mean(), "loss_vlb": loss_vlb, "loss": loss}


def p_sample(tbl: DDPMTables, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor, clip_denoised: bool = True,
             temperature: float = 1.0) -> torch.Tensor:
    """One ancestral step: the posterior mean of the (clipped) predicted
    x_0, plus posterior log-variance noise where t > 0."""
    model_out = model_fn(x, t).float()
    if tbl.parameterization == "eps":
        x_recon = predict_start_from_noise(tbl, x, t, model_out)
    else:
        x_recon = model_out
    if clip_denoised:
        x_recon = x_recon.clamp(-1.0, 1.0)
    mean, _, logvar = q_posterior(tbl, x_recon, x, t)
    nonzero = (t > 0).to(x.dtype).reshape(t.shape + (1,) * (x.dim() - t.dim()))
    return mean + nonzero * torch.exp(0.5 * logvar) * noise * temperature


def p_sample_loop(tbl: DDPMTables, model_fn: ModelFn, shape: Tuple[int, ...],
                  noise: Noise, clip_denoised: bool = True,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """The full reverse chain t = T-1..0 from x_T ~ N(0, I) of ``shape``,
    fp32 on ``device`` (a generator's own device when ``noise`` is one).
    Draws from ``noise``: x_T, then one per step."""
    if isinstance(noise, torch.Generator):
        device = noise.device
    x = draw_noise(noise, torch.empty(shape, device=device))
    for step in range(tbl.num_timesteps - 1, -1, -1):
        t = torch.full((shape[0],), step, dtype=torch.long, device=x.device)
        x = p_sample(tbl, model_fn, x, t, draw_noise(noise, x), clip_denoised)
    return x
