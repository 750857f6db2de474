"""Bulk DiT-XL/2 sampling: ``make_ldm_sampler``'s guided ``sample(scale_factor,
seeds, labels, guidance_scale)`` at the cell's batch on the DiT that
``build_models`` builds from the configuration, the configuration's
guidance scale, the cell's loop (DPM-Solver++(2M)) over its steps, the
AEKL decode and the crop, each batch read back with ``.cpu()``, no
artifacts written. A seed's label is the seed mod the classes, so every
batch holds each sleep stage; each step is one forward of the 2B batch.

Checked as the LDM cell is (``sample_ldm``): a sample of the window's
windows, drawn from the seed, and the latents the timed path handed to the
decode, against the float32 reference (``reference/dit.py``, the same
guided loop, decode and crop) of the same seeds, each gap over the gap of
the reference computed with fp8 products. ``control`` puts the fp8
reference in the program's place; ``faults`` three faulty references:
guidance off (the null branch dropped), one block skipped, and attention
without its d^-1/2 scale.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import common, flops, weights
from portbench.drivers import sample_ldm
from portbench.reference import dit as rdit, loops, models as ref

SPANS = ("sample.batch", "sample.readback")


def fault_kinds(cfg: dict) -> dict:
    """The planted faults: guidance off, the middle block skipped, and
    attention without its scale."""
    return {"unguided": {"unguided": True},
            "skip_block": {"skip_block": cfg["dit"]["depth"] // 2},
            "unscaled_attention": {"attention_scale": False}}


def reference_dit(cfg: dict, prec: ref.Precision | None = None, **fault) -> rdit.DiT:
    d = cfg["dit"]
    return rdit.DiT(d["in_channels"], d["input_size"], d["patch_size"], d["hidden_size"],
                    d["depth"], d["num_heads"], d["mlp_ratio"], d["num_classes"], prec, **fault)


def dit_weights(cfg: dict, seed: int, device) -> dict:
    """The DiT's weights from the seed, as served (bf16 values in fp32)."""
    return common.seeded_weights(lambda: reference_dit(cfg), seed, device, weights.WEIGHTS_UNET)


def labels_of(cfg: dict, seeds, device) -> torch.Tensor:
    """Each seed's sleep stage: the seed mod the classes."""
    return torch.tensor([s % cfg["dit"]["num_classes"] for s in seeds], dtype=torch.int64,
                        device=device)


def forward_flops(cfg: dict, rows: int) -> float:
    """One forward of the reference DiT over ``rows`` latents, on meta tensors."""
    d = cfg["dit"]
    with torch.device("meta"):
        dit = reference_dit(cfg)
        x = torch.empty(rows, d["in_channels"], d["input_size"])
        t = torch.zeros(rows, dtype=torch.int64)
    with torch.no_grad():
        return flops._count(lambda: dit(x, t))


def decode_flops(cfg: dict, rows: int) -> float:
    a = cfg["aekl"]
    with torch.device("meta"):
        ae = common.reference_aekl(cfg)
        z = torch.empty(rows, a["latent_channels"], cfg["dit"]["input_size"])
    with torch.no_grad():
        return flops._count(lambda: ae.decode(z))


def program_models(ctx, store: list):
    from sleepgen_torch.sample.sample_ldm import build_models

    dev = torch.device(ctx.device)
    cfg, aekl_cfg = common.program_configs(ctx.cfg)
    dit, ae = build_models(cfg, common.to_numpy(dit_weights(ctx.cfg, ctx.seed, dev)),
                           common.to_numpy(common.aekl_weights(ctx.cfg, ctx.seed, dev)), dev,
                           aekl_cfg)
    sample_ldm.keep_latents(ae, store)
    return cfg, aekl_cfg, dit, ae


def program_sampler(ctx, models, steps: int):
    """``sample(seeds)``: the guided sampler over ``steps``."""
    from sleepgen_torch.sample.sample_ldm import make_ldm_sampler, sampling_schedule

    spec, dev = ctx.spec, torch.device(ctx.device)
    cfg, aekl_cfg, dit, ae = models
    sampler = make_ldm_sampler(dit, ae, sampling_schedule(cfg, dev), cfg.image_size,
                               aekl_cfg.aekl.latent_channels, steps, sampler=spec["sampler"],
                               device=dev, conditional=True, guided=True)
    scale = ctx.cfg["guidance_scale"]
    return lambda seeds: sampler(spec["scale_factor"], seeds, labels_of(ctx.cfg, seeds, dev),
                                 scale)


def setup(ctx):
    spec, latents = ctx.spec, []
    models = program_models(ctx, latents)
    # the timed shapes, in a loop of few steps: the 2B forward, the decode
    program_sampler(ctx, models, spec["warm_steps"])(list(range(spec["batch"]))).cpu()
    if torch.device(ctx.device).type == "cuda":  # the peak of serving, not of the weights' draw
        torch.cuda.reset_peak_memory_stats()
    return {"sample": program_sampler(ctx, models, spec["steps"]), "latents": latents}


def window(ctx, state):
    spec = ctx.spec
    state["latents"].clear()
    record = common.batch_loop(ctx, state["sample"], spec["batch"], spec["steps"])
    state["next_seed"] = record["next_seed"]
    counted = len(record["windows"]) // spec["batch"]
    record["latents"] = sample_ldm.stacked(state["latents"][:counted])
    return record


def profile(ctx, state):
    """One batch, as the window runs it, on seeds the window did not use."""
    from portbench.harness import span

    seeds = list(range(state["next_seed"], state["next_seed"] + ctx.spec["batch"]))
    with span("sample.batch"):
        out = state["sample"](seeds)
    with span("sample.readback"):
        out.cpu()
    return {"forwards": ctx.spec["steps"], "batch": ctx.spec["batch"]}


def release(state):
    state.clear()


def reference_outputs(cfg: dict, spec: dict, seed: int, seeds, device,
                      prec: ref.Precision | None = None, fault: dict | None = None):
    """(windows (N, 3000, 1), latents over the scale factor (N, C, L)) of
    ``seeds`` from the reference at ``prec``, with a fault (``fault_kinds``)
    planted."""
    ref.set_fp32_math()
    fault = dict(fault or {})
    unguided = fault.pop("unguided", False)
    dit = common.loaded(reference_dit(cfg, prec, **fault).to(device),
                        dit_weights(cfg, seed, device))
    ae = sample_ldm.reference_decoder(cfg, seed, device, prec)
    d = cfg["diffusion"]
    acp = loops.alphas_cumprod(d["sample_schedule"], d["timesteps"], d["sample_beta_start"],
                               d["sample_beta_end"])
    loop = sample_ldm.LOOPS[spec["sampler"]]
    latents = []

    def block(chunk):
        x = loops.seed_noise(chunk, cfg["aekl"]["latent_channels"],
                             cfg["dit"]["input_size"]).to(device)
        y = labels_of(cfg, chunk, device)
        model = (rdit.conditional(dit, y) if unguided
                 else rdit.guided(dit, y, cfg["guidance_scale"]))
        with torch.no_grad():
            z = loop(model, acp, x, spec["steps"]) / spec["scale_factor"]
            latents.append(z.cpu().numpy())
            return loops.crop(ae.decode(z)).cpu().numpy()

    windows = common.in_blocks(block, list(seeds), spec["check_block"])
    return windows, np.concatenate(latents)


def numbers(ctx, who: str, windows: np.ndarray, latents: np.ndarray, names) -> dict:
    """``sample_ldm.numbers`` against this cell's reference: the worst
    window's ``window_rel_l2`` and ``latent_rel_l2``, and ``window_gap_fp8``
    and ``latent_gap_fp8``, each gap over the fp8 reference's on that
    window."""
    seeds, want_w, want_z = ctx.reference
    win = common.window_gaps(windows, want_w)
    lat = common.window_gaps(latents, want_z)
    ctx.detail[who], ctx.detail[who + ".latent"] = win, lat
    if ctx.yardstick is None:
        fw, fz = fp8_outputs(ctx)
        ctx.yardstick = (common.window_gaps(fw, want_w)[0], common.window_gaps(fz, want_z)[0])
    out = {"window_rel_l2": sample_ldm.rel(win), "latent_rel_l2": sample_ldm.rel(lat),
           "window_gap_fp8": max(e / u for e, u in zip(win[0], ctx.yardstick[0])),
           "latent_gap_fp8": max(e / u for e, u in zip(lat[0], ctx.yardstick[1]))}
    return {k: out[k] for k in names}


def fp8_outputs(ctx):
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
    """The reference in fp8 in the program's place (1 by construction)."""
    return list(numbers(ctx, "fp8_reference", *fp8_outputs(ctx), ctx.spec["limits"]).items())


def faults(ctx, record):
    """Each of ``fault_kinds``' references in the program's place."""
    seeds, names = ctx.reference[0], ctx.spec["limits"]
    return {name: list(numbers(ctx, name, *reference_outputs(
        ctx.cfg, ctx.spec, ctx.seed, seeds, ctx.device, fault=fault), names).items())
        for name, fault in fault_kinds(ctx.cfg).items()}
