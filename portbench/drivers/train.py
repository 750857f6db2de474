"""Stage-2 training: ``make_ldm_train_step`` at the configuration's batch,
on a UNet with fp32 master weights and Adam, under a frozen bf16 AEKL, as
``build_trainer`` composes them (from the seed's weights, not its
initialiser), with the scale factor of ``compute_scale_factor`` on the
first batch. Set-up prepares a pool of distinct input batches (windows
N(0, 1) and each step's encoder noise, timesteps and latent noise, drawn
in ``draw_step_inputs``' order); the window's steps cycle through it.

Set-up drives the step through its first three batches: their losses, the
first gradient as Adam holds it after step one, and the parameters after
step three are kept. The check runs the float32 reference over the same
three batches, in blocks of rows, and compares each step's loss, each
leaf's gradient norm and each leaf's change (leaf by leaf, the gap of the
norms against the larger of the leaf's and the median leaf's reference
norm; leaves whose reference gradient is under a thousandth of the median
leaf's left out of the change), and the part of the first gradient's gap
that lies along the differences between the reference's block means: a
step that averages the wrong rows, such as half of the batch, moves it
there.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import common, harness, weights
from portbench.reference import loops, models as ref

SPANS = ("train.step",)
CHECKED_STEPS = 3


def latent_shape(cfg: dict):
    a = cfg["aekl"]
    length = cfg["window"]
    for _ in range(len(a["num_channels"]) - 1):
        length = (length + 1) // 2
    return a["latent_channels"], length


def step_inputs(cfg: dict, seed: int, batch: int, i: int, device):
    """(x, t, noise, enc_eps) of pool entry ``i``: the windows, then the
    encoder's eps, the timesteps and the latent noise. The timesteps are
    sorted: the rows are iid, so this only orders them, and a step that
    left out a contiguous half would see timesteps of one end of the range
    only, which moves its gradient far more than rounding does."""
    g = weights.generator(seed, device, weights.STEP_INPUTS, i)
    lat = latent_shape(cfg)
    x = torch.randn((batch, 1, cfg["window"]), generator=g, device=device)
    enc_eps = torch.randn((batch, *lat), generator=g, device=device)
    t = torch.randint(0, cfg["diffusion"]["timesteps"], (batch,), generator=g, device=device)
    noise = torch.randn((batch, *lat), generator=g, device=device)
    return x, torch.sort(t).values, noise, enc_eps


def scale_eps(cfg: dict, seed: int, batch: int, device):
    g = weights.generator(seed, device, weights.SCALE_EPS)
    return torch.randn((batch, *latent_shape(cfg)), generator=g, device=device)


def setup(ctx):
    from sleepgen_torch.nn.layers import cast_compute_dtype
    from sleepgen_torch.sample.sample_ldm import DTYPES, build_aekl, build_unet
    from sleepgen_torch.train.train_ldm import (compute_scale_factor, make_ldm_train_step,
                                                make_schedule)

    spec, dev, batch = ctx.spec, torch.device(ctx.device), ctx.spec["batch"]
    cfg, aekl_cfg = common.program_configs(ctx.cfg)
    lc = aekl_cfg.aekl.latent_channels
    dtype = DTYPES[cfg.dtype]
    with torch.device(dev):
        ae = build_aekl(aekl_cfg)
        unet = build_unet(cfg, lc, lc, cfg.fast_train_math)
    ae.load_state_dict(common.aekl_weights(ctx.cfg, ctx.seed, dev))
    cast_compute_dtype(ae.eval(), dtype).requires_grad_(False)
    unet.load_state_dict(common.unet_weights(ctx.cfg, ctx.seed, dev, served=False))
    opt = torch.optim.Adam(unet.parameters(), lr=cfg.train.base_lr)
    pool = [step_inputs(ctx.cfg, ctx.seed, batch, i, dev) for i in range(spec["pool"])]
    sf = compute_scale_factor(ae, pool[0][0], scale_eps(ctx.cfg, ctx.seed, batch, dev))
    step = make_ldm_train_step(unet, ae, make_schedule(cfg, dev), opt, sf, dtype)
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


def window(ctx, state):
    step, pool, batch = state["step"], state["pool"], ctx.spec["batch"]
    losses = []
    harness.sync(ctx.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        with harness.span("train.step"):
            losses.append(step(*pool[state["next"] % len(pool)]))
        state["next"] += 1
    harness.sync(ctx.device)
    seconds = time.perf_counter() - t0
    cuda = torch.device(ctx.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"metrics": {"train_windows_per_s": len(losses) * batch / seconds,
                        "train_peak_mem_gib": peak / 2**30},
            "attempted": len(losses), "failed": failed, "steps": len(losses),
            "step_s": seconds / len(losses), "batch": batch, "checked": state["checked"]}


def profile(ctx, state):
    for _ in range(ctx.spec["profile_steps"]):
        with harness.span("train.step"):
            state["step"](*state["pool"][state["next"] % len(state["pool"])])
        state["next"] += 1
    return {"steps": ctx.spec["profile_steps"], "batch": ctx.spec["batch"]}


def release(state):
    state.clear()


def reference_steps(cfg: dict, seed: int, batch: int, block: int, device,
                    prec: ref.Precision | None = None, rows: int | None = None) -> dict:
    """The reference's first three steps from the seed's weights on the
    pool's first three batches: each step's loss, the first gradient, the
    first gradient's mean over each block of ``block`` rows, and the
    parameters after step three, by leaf. ``rows`` keeps only the first
    rows of each batch (the fault of a step that leaves out half)."""
    ref.set_fp32_math()
    unet = common.reference_unet(cfg, prec).to(device)
    unet.load_state_dict(common.unet_weights(cfg, seed, device, served=False))
    ae = common.loaded(common.reference_aekl(cfg, prec).to(device),
                       common.aekl_weights(cfg, seed, device))
    d = cfg["diffusion"]
    acp = loops.alphas_cumprod(d["beta_schedule"], d["timesteps"], d["linear_start"],
                               d["linear_end"])
    x0 = step_inputs(cfg, seed, batch, 0, device)[0]
    with torch.no_grad():
        sf = float(1.0 / ae.posterior_sample(x0, scale_eps(cfg, seed, batch, device))
                   .std(correction=0))
    params = dict(unet.named_parameters())
    adam = loops.Adam({k: p.data for k, p in params.items()}, cfg["train"]["base_lr"])
    out = {"loss": [], "grad1": None, "grad1_blocks": [], "params3": None}
    for i in range(CHECKED_STEPS):
        x, t, noise, enc_eps = step_inputs(cfg, seed, batch, i, device)
        n = rows or batch
        total = 0.0
        before = {k: torch.zeros_like(p, device="cpu") for k, p in params.items()}
        for s in range(0, n, block):
            e = min(n, s + block)
            part = loops.ldm_losses(unet, ae, acp, sf, x[s:e], t[s:e], noise[s:e],
                                    enc_eps[s:e]).sum() / n
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


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's | ||program|| - ||reference|| | over the larger of
    its reference norm and the median leaf's."""
    names = [k for k in reference if keep is None or k in keep]
    rn = {k: float(reference[k].double().norm()) for k in names}
    med = float(np.median(list(rn.values())))
    return max(abs(float(program[k].double().norm()) - rn[k]) / max(rn[k], med) for k in names)


def row_gap(program: dict, reference: dict, blocks: list) -> float:
    """The part of the gap between the program's first gradient and the
    reference's that a change of the rows it averages explains: the gap
    projected onto the span of the reference's block means less their
    mean, over the reference gradient's norm (every leaf as one vector).
    Half a batch left out moves the gradient inside that span by the
    batch's sampling noise; rounding moves it across all parameters."""
    k = len(blocks)
    gram = torch.zeros(k, k, dtype=torch.float64)
    rhs = torch.zeros(k, dtype=torch.float64)
    ref_sq = 0.0
    for name, r in reference.items():
        r = r.double().flatten()
        dev = torch.stack([b[name].double().flatten() - r for b in blocks])
        gram += dev @ dev.T
        rhs += dev @ (program[name].double().flatten() - r)
        ref_sq += float(r @ r)
    c = torch.linalg.pinv(gram) @ rhs
    return float(c @ gram @ c) ** 0.5 / ref_sq ** 0.5


def compare(cfg: dict, seed: int, got: dict, want: dict, device) -> dict:
    """The four compared numbers of ``got`` (the program's readings, or a
    stand-in's) against the reference's ``want``."""
    theta0 = {k: v.cpu() for k, v in common.unet_weights(cfg, seed, device, served=False).items()}
    gn = {k: float(g.double().norm()) for k, g in want["grad1"].items()}
    med = float(np.median(list(gn.values())))
    moving = {k for k, v in gn.items() if v >= 1e-3 * med}
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
            "grad1_leaf": leaf_gap(got["grad1"], want["grad1"]),
            "change3_leaf": leaf_gap({k: got["params3"][k] - theta0[k] for k in theta0},
                                     {k: want["params3"][k] - theta0[k] for k in theta0},
                                     moving),
            "grad1_rows": row_gap(got["grad1"], want["grad1"], want["grad1_blocks"])}


def check(ctx, record):
    spec = ctx.spec
    ctx.reference = reference_steps(ctx.cfg, ctx.seed, spec["batch"], spec["check_block"],
                                    ctx.device)
    got = compare(ctx.cfg, ctx.seed, record["checked"], ctx.reference, ctx.device)
    return [(name, got[name], spec["limits"][name]) for name in spec["limits"]]


def control(ctx, record):
    """The reference in fp8 in the program's place, against the reference."""
    spec = ctx.spec
    got = reference_steps(ctx.cfg, ctx.seed, spec["batch"], spec["check_block"], ctx.device,
                          ref.Precision("fp8"))
    return list(compare(ctx.cfg, ctx.seed, got, ctx.reference, ctx.device).items())


def faults(ctx, record):
    """A step that leaves out half of the batch and takes the mean over the
    rest, in the reference put in the program's place."""
    spec = ctx.spec
    got = reference_steps(ctx.cfg, ctx.seed, spec["batch"], spec["check_block"], ctx.device,
                          rows=spec["batch"] // 2)
    return {"half_batch": list(compare(ctx.cfg, ctx.seed, got, ctx.reference,
                                       ctx.device).items())}
