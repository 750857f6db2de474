"""DPM-Solver++(2M): second-order multistep sampling of the probability-flow ODE.

Counterpart of ``sleepgen/diffusion/dpm_solver.py`` (Lu et al. 2022, the
multistep data-prediction variant). Timesteps are uniform in log-SNR
(lambda) and end at t = 0; the first step is first order (the multistep
warm-up) and the loop returns the final data prediction, as DDIM's last
step does. It works with any prediction type through
``NoiseSchedule.to_x0_eps``.

The loop is a Python loop like ``samplers.ddim_sample_loop``: x stays fp32
and the model output is cast to fp32. The per-step coefficients are
scalars, computed once on the host from the schedule's fp32 tables, so a
step launches no work but the model call and two tensor updates, and the
loop never waits for the card.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from sleepgen_torch.diffusion.schedules import NoiseSchedule
from sleepgen_torch.utils.profiling import span


def dpm_timesteps(sched: NoiseSchedule, num_inference_steps: int) -> np.ndarray:
    """Descending int32 timesteps, uniform in log-SNR, strictly decreasing,
    ending at t = 0. Integers identical to the JAX package's for the same
    schedule: both start from the same fp32 ``alphas_cumprod``, read here
    from the host copy so that no call waits for the card."""
    acp = sched.alphas_cumprod_host.astype(np.float64)
    lam = 0.5 * np.log(acp) - 0.5 * np.log(1.0 - acp)  # decreasing in t
    targets = np.linspace(lam[-1], lam[0], num_inference_steps)
    # inverse-interpolate lambda -> fractional t (np.interp needs ascending x)
    t_frac = np.interp(targets, lam[::-1], np.arange(len(lam))[::-1])
    ts = np.round(t_frac).astype(np.int64)  # descending, may collide near 0
    ts[-1] = 0
    # resolve collisions by pushing earlier entries up (headroom at high t)
    for i in range(len(ts) - 2, -1, -1):
        ts[i] = max(ts[i], ts[i + 1] + 1)
    if ts[0] >= len(lam):
        raise ValueError(f"{num_inference_steps} steps are too many for a "
                         f"{len(lam)}-step schedule")
    return ts.astype(np.int32)


def dpm_solver_pp_2m_sample_loop(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                                 sched: NoiseSchedule, x_T: torch.Tensor,
                                 num_inference_steps: int = 20) -> torch.Tensor:
    """DPM-Solver++(2M) from x_T (any layout the model takes) with
    ``num_inference_steps`` model calls; returns the final data prediction
    x0 in fp32. ``model_fn(x, t_batch)`` is the network, read under
    ``sched.prediction_type``. Each model call is a ``sampler.step`` span;
    its data prediction and the solver's move to the next timestep (none
    after the last call) a ``sampler.update`` span inside it."""
    ts = dpm_timesteps(sched, num_inference_steps).tolist()
    acp = sched.alphas_cumprod_host.astype(np.float64)
    alphas = np.sqrt(acp)  # x_t = alpha_t x0 + sigma_t eps
    sigmas = np.sqrt(1.0 - acp)
    lambdas = np.log(alphas) - np.log(sigmas)  # log-SNR

    x = x_T.float()
    x0_older, h_prev = None, 1.0
    for i, t_cur in enumerate(ts):
        with span("sampler.step"):
            t_b = torch.full((x.shape[0],), t_cur, dtype=torch.int64, device=x.device)
            out = model_fn(x, t_b).float()
            with span("sampler.update"):
                x0_cur = sched.to_x0_eps(out, x, t_cur)[0]
                if i + 1 < len(ts):
                    t_next = ts[i + 1]
                    h = float(lambdas[t_next] - lambdas[t_cur])
                    if i == 0:  # first order on the warm-up step
                        d = x0_cur
                    else:  # second-order extrapolation from the last two predictions
                        c = h / (2.0 * h_prev)
                        d = (1.0 + c) * x0_cur - c * x0_older
                    x = float(sigmas[t_next] / sigmas[t_cur]) * x \
                        - float(alphas[t_next] * math.expm1(-h)) * d
                    x0_older, h_prev = x0_cur, h
    # denoise-to-zero: the data prediction at the final (t = 0) state
    return x0_cur
