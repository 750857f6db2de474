"""Bulk LDM sampling: ``make_ldm_sampler``'s ``sample(scale_factor, seeds)``
at the cell's batch, the UNet's loop (DDIM or DPM-Solver++(2M)) over its
steps, the AEKL decode and the crop, each batch read back with ``.cpu()``
as ``sample_ldm_trials`` reads it, no artifacts written.

Checked: a sample of the window's windows, drawn from the seed, against the
float32 reference of the same seeds (the same loop, decode and crop), and
the latents the timed path handed to the decode, against the reference's.
The latents are kept by a wrapper of the AEKL's ``decode_stage_2_outputs``
that holds a reference to its input and does no device work.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import common
from portbench.reference import loops, models as ref

SPANS = ("sample.batch", "sample.readback")
LOOPS = {"ddim": loops.ddim, "dpm++2m": loops.dpm_pp_2m}


def keep_latents(ae, store: list) -> None:
    """Each call of ``ae``'s decode appends its input, the latent over the
    scale factor, to ``store``."""
    decode = ae.decode_stage_2_outputs

    def kept(z):
        store.append(z)
        return decode(z)

    ae.decode_stage_2_outputs = kept


def program_sampler(ctx, steps: int, store: list, quantized: bool = False):
    from sleepgen_torch.sample.sample_ldm import build_models, make_ldm_sampler, sampling_schedule

    spec, dev = ctx.spec, torch.device(ctx.device)
    cfg, aekl_cfg = common.program_configs(ctx.cfg)
    unet, ae = build_models(cfg, common.to_numpy(common.unet_weights(ctx.cfg, ctx.seed, dev)),
                            common.to_numpy(common.aekl_weights(ctx.cfg, ctx.seed, dev)), dev,
                            aekl_cfg, quantized=quantized)
    keep_latents(ae, store)
    return make_ldm_sampler(unet, ae, sampling_schedule(cfg, dev), cfg.unet.image_size,
                            aekl_cfg.aekl.latent_channels, steps, sampler=spec["sampler"],
                            device=dev, quantized=quantized)


def setup(ctx):
    spec, latents = ctx.spec, []
    # the timed shapes, in a loop of few steps: the UNet at the batch, the decode
    program_sampler(ctx, spec["warm_steps"], [])(spec["scale_factor"],
                                                 list(range(spec["batch"]))).cpu()
    return {"sample": program_sampler(ctx, spec["steps"], latents), "latents": latents}


def window(ctx, state):
    spec = ctx.spec
    state["latents"].clear()
    record = common.batch_loop(ctx, lambda seeds: state["sample"](spec["scale_factor"], seeds),
                               spec["batch"], spec["steps"])
    state["next_seed"] = record["next_seed"]
    counted = len(record["windows"]) // spec["batch"]
    record["latents"] = stacked(state["latents"][:counted])
    return record


def stacked(latents: list) -> np.ndarray:
    if not latents:
        return np.zeros((0,))
    return torch.cat(latents).float().cpu().numpy()


def profile(ctx, state):
    """One batch, as the window runs it, on seeds the window did not use."""
    from portbench.harness import span

    seeds = list(range(state["next_seed"], state["next_seed"] + ctx.spec["batch"]))
    with span("sample.batch"):
        out = state["sample"](ctx.spec["scale_factor"], seeds)
    with span("sample.readback"):
        out.cpu()
    return {"unet_forwards": ctx.spec["steps"], "batch": ctx.spec["batch"]}


def release(state):
    state.clear()


def reference_outputs(cfg: dict, spec: dict, seed: int, seeds, device,
                      prec: ref.Precision | None = None):
    """(windows (N, 3000, 1), latents over the scale factor (N, C, L)) of
    ``seeds`` from the reference at ``prec``."""
    ref.set_fp32_math()
    unet = common.loaded(common.reference_unet(cfg, prec).to(device),
                         common.unet_weights(cfg, seed, device))
    ae = reference_decoder(cfg, seed, device, prec)
    d = cfg["diffusion"]
    acp = loops.alphas_cumprod(d["sample_schedule"], d["timesteps"], d["sample_beta_start"],
                               d["sample_beta_end"])
    loop = LOOPS[spec["sampler"]]
    latents = []

    def block(chunk):
        x = loops.seed_noise(chunk, cfg["aekl"]["latent_channels"],
                             cfg["unet"]["image_size"]).to(device)
        with torch.no_grad():
            z = loop(unet, acp, x, spec["steps"]) / spec["scale_factor"]
            latents.append(z.cpu().numpy())
            return loops.crop(ae.decode(z)).cpu().numpy()

    windows = common.in_blocks(block, list(seeds), spec["check_block"])
    return windows, np.concatenate(latents)


def reference_windows(cfg: dict, spec: dict, seed: int, seeds, device,
                      prec: ref.Precision | None = None) -> np.ndarray:
    return reference_outputs(cfg, spec, seed, seeds, device, prec)[0]


def reference_decoder(cfg: dict, seed: int, device, prec: ref.Precision | None = None):
    return common.loaded(common.reference_aekl(cfg, prec).to(device),
                         common.aekl_weights(cfg, seed, device))


def rel(gaps) -> float:
    err, norm = gaps
    return max(e / n for e, n in zip(err, norm))


def numbers(ctx, who: str, windows: np.ndarray, latents: np.ndarray, names) -> dict:
    """The compared numbers ``names`` of the outputs of ``who`` (the
    program, or a stand-in in its place) against the last check's
    reference: the worst window's ``window_rel_l2`` and ``latent_rel_l2``,
    ||p - r|| / ||r|| of the windows and of the latents; ``window_gap_fp8``
    and ``latent_gap_fp8``, the worst gap over the gap the reference
    computed with fp8 products makes on that window (the seed's weights set
    how far the decode amplifies rounding, alike for every precision)."""
    seeds, want_w, want_z = ctx.reference
    win = common.window_gaps(windows, want_w)
    lat = common.window_gaps(latents, want_z)
    ctx.detail[who], ctx.detail[who + ".latent"] = win, lat
    out = {"window_rel_l2": rel(win), "latent_rel_l2": rel(lat)}
    if {"window_gap_fp8", "latent_gap_fp8"} & set(names):
        if ctx.yardstick is None:
            fw, fz = fp8_outputs(ctx)
            ctx.yardstick = (common.window_gaps(fw, want_w)[0], common.window_gaps(fz, want_z)[0])
        out["window_gap_fp8"] = max(e / u for e, u in zip(win[0], ctx.yardstick[0]))
        out["latent_gap_fp8"] = max(e / u for e, u in zip(lat[0], ctx.yardstick[1]))
    return {k: out[k] for k in names}


def fp8_outputs(ctx):
    """The reference's outputs with fp8 products on the last check's seeds
    (computed once a check)."""
    if ctx.fp8 is None:
        ctx.fp8 = reference_outputs(ctx.cfg, ctx.spec, ctx.seed, ctx.reference[0], ctx.device,
                                    ref.Precision("fp8"))
    return ctx.fp8


def check(ctx, record):
    limits = ctx.spec["limits"]
    if not len(record["windows"]):
        return [(name, float("inf"), limit) for name, limit in limits.items()]
    idx = common.check_sample(ctx, record, ctx.spec["check_windows"])
    seeds = [record["seeds"][i] for i in idx]
    ctx.reference = (seeds, *reference_outputs(ctx.cfg, ctx.spec, ctx.seed, seeds, ctx.device))
    ctx.yardstick = ctx.fp8 = None
    got = numbers(ctx, "program", record["windows"][idx], record["latents"][idx], limits)
    return [(name, got[name], limit) for name, limit in limits.items()]


def control(ctx, record):
    """Two stand-ins in the program's place: the program's own int8 path
    (``quantized=True``; each batch that holds a checked window sampled
    again, whole) and the reference in fp8."""
    spec, batch, names = ctx.spec, ctx.spec["batch"], ctx.spec["limits"]
    seeds = ctx.reference[0]
    store = []
    sample = program_sampler(ctx, spec["steps"], store, quantized=True)
    got_w, got_z = {}, {}
    for b in sorted({(s - ctx.seed) // batch for s in seeds}):
        chunk = list(range(ctx.seed + batch * b, ctx.seed + batch * (b + 1)))
        got_w.update(zip(chunk, sample(spec["scale_factor"], chunk).cpu().numpy()))
        got_z.update(zip(chunk, stacked(store[-1:])))
    int8 = numbers(ctx, "int8", np.stack([got_w[s] for s in seeds]),
                   np.stack([got_z[s] for s in seeds]), names)
    fp8 = numbers(ctx, "fp8_reference", *fp8_outputs(ctx), names)
    return [(f"{k}.int8", v) for k, v in int8.items()] + list(fp8.items())
