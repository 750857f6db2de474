"""Signal-space DM training: ``train_dm.make_dm_train_step`` at the
configuration's batch, on the UNet with fp32 master weights and Adam as
``build_dm_trainer`` composes them (then loaded with the seed's weights,
not its initialiser), bf16 autocast, unconditional, no spectral term. No
encode: the UNet runs on the windows themselves. Set-up prepares a pool of
distinct batches (windows N(0, 1) rounded to bf16 values, as the trainer
feeds them, timesteps uniform over the training table and sorted within
the batch, the noise); the window's steps cycle through it.

Checked as the stage-2 cell is (``train``, whose window, traced steps,
comparison, control and half-batch fault this driver takes as they are):
the first three steps' losses, first gradient and parameters after step
three against the float32 reference (``reference/models.py``'s UNet on the
training schedule of the configuration's YAML, epsilon target) over the
same batches in blocks of rows.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import common, flops, harness, weights
from portbench.reference import loops, models as ref

base = harness.load_module("drivers", "train")  # this cell's own copy
SPANS = base.SPANS
CHECKED_STEPS = base.CHECKED_STEPS


def training_schedule(cfg: dict) -> dict:
    """The ``diffusion`` section of the configuration's YAML: the training
    table (linear betas) and the target."""
    import yaml

    d = yaml.safe_load((harness.ROOT / cfg["yaml"][0]).read_text())["diffusion"]
    if d["prediction_type"] != "epsilon":
        raise ValueError(f"the reference fits epsilon, not {d['prediction_type']!r}")
    return d


def step_inputs(cfg: dict, seed: int, batch: int, i: int, device):
    """(x, t, noise) of pool entry ``i``: the windows rounded to bf16 values,
    the timesteps sorted (as the stage-2 cell sorts them), the noise."""
    g = weights.generator(seed, device, weights.STEP_INPUTS, i)
    length = cfg["unet"]["image_size"]
    x = torch.randn((batch, 1, length), generator=g, device=device).bfloat16().float()
    t = torch.randint(0, training_schedule(cfg)["timesteps"], (batch,), generator=g,
                      device=device)
    noise = torch.randn((batch, 1, length), generator=g, device=device)
    return x, torch.sort(t).values, noise


def setup(ctx):
    from sleepgen_torch.sample.sample_ldm import DTYPES
    from sleepgen_torch.train.train_dm import build_dm_trainer, make_dm_train_step

    spec, dev, batch = ctx.spec, torch.device(ctx.device), ctx.spec["batch"]
    (cfg,) = common.program_configs(ctx.cfg)
    unet, sched, opt = build_dm_trainer(cfg, dev)
    unet.load_state_dict(common.unet_weights(ctx.cfg, ctx.seed, dev, served=False))
    dm_step = make_dm_train_step(unet, sched, opt, cfg.spectral, DTYPES[cfg.dtype])

    def step(x, t, noise):
        return dm_step(x, t, noise)["loss"]

    pool = [step_inputs(ctx.cfg, ctx.seed, batch, i, dev) for i in range(spec["pool"])]
    named = dict(unet.named_parameters())
    beta1 = opt.defaults["betas"][0]
    losses, grad1 = [], None
    for i in range(CHECKED_STEPS):
        losses.append(step(*pool[i]))
        if i == 0:
            # a leaf without Adam state got no gradient: it reads zero
            grad1 = {k: (opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - beta1)).cpu()
                     for k, p in named.items()}
    params3 = {k: p.detach().to("cpu", copy=True) for k, p in named.items()}
    for i in range(CHECKED_STEPS, spec["pool"]):  # every pool entry once before the window
        step(*pool[i])
    harness.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    return {"step": step, "pool": pool, "next": spec["pool"],
            "checked": {"loss": [float(v) for v in losses], "grad1": grad1, "params3": params3}}


def dm_losses(unet, acp: np.ndarray, x, t, noise):
    """Per-window epsilon-prediction MSE of windows x noised at t."""
    a = torch.as_tensor(acp, device=x.device)[t][:, None, None]
    noisy = a.sqrt() * x + (1.0 - a).sqrt() * noise
    return (unet(noisy, t) - noise).square().mean(dim=(1, 2))


def reference_steps(cfg: dict, seed: int, batch: int, block: int, device,
                    prec: ref.Precision | None = None, rows: int | None = None) -> dict:
    """``train.reference_steps`` without the encode: the reference UNet's
    first three steps on the pool's first three batches, in blocks of
    ``block`` rows; ``rows`` keeps only the first rows of each batch."""
    ref.set_fp32_math()
    with torch.device(device):
        unet = common.reference_unet(cfg, prec)
    unet.load_state_dict(common.unet_weights(cfg, seed, device, served=False))
    d = training_schedule(cfg)
    acp = loops.alphas_cumprod(d["beta_schedule"], d["timesteps"], d["linear_start"],
                               d["linear_end"])
    params = dict(unet.named_parameters())
    adam = loops.Adam({k: p.data for k, p in params.items()}, cfg["train"]["base_lr"])
    out = {"loss": [], "grad1": None, "grad1_blocks": [], "params3": None}
    for i in range(CHECKED_STEPS):
        x, t, noise = step_inputs(cfg, seed, batch, i, device)
        n = rows or batch
        total = 0.0
        before = {k: torch.zeros_like(p, device="cpu") for k, p in params.items()}
        for s in range(0, n, block):
            e = min(n, s + block)
            part = dm_losses(unet, acp, x[s:e], t[s:e], noise[s:e]).sum() / n
            part.backward()
            total += float(part.detach())
            if i == 0:
                now = {k: p.grad.detach().to("cpu", copy=True) for k, p in params.items()}
                out["grad1_blocks"].append({k: (now[k] - before[k]) * (n / (e - s))
                                            for k in now})
                before = now
        grads = {k: p.grad for k, p in params.items()}
        if i == 0:
            out["grad1"] = {k: g.detach().to("cpu", copy=True) for k, g in grads.items()}
        adam.step(grads)
        unet.zero_grad(set_to_none=True)
        out["loss"].append(total)
    out["params3"] = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    return out


def step_flops(cfg: dict, batch: int) -> float:
    """One step's FLOPs: the reference UNet's forward and backward over
    (batch, 1, window) windows (no recomputation), on meta tensors."""
    with torch.device("meta"):
        unet = common.reference_unet(cfg)
        x = torch.empty(batch, 1, cfg["unet"]["image_size"])
        t = torch.zeros(batch, dtype=torch.int64)
    return flops._count(lambda: unet(x, t).square().mean().backward())


base.reference_steps = reference_steps
window, profile, release = base.window, base.profile, base.release
check, control, faults = base.check, base.control, base.faults
