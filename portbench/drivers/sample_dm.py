"""Bulk sampling of the signal-space DM: the loop of ``sample_dm_trials``
(``build_dm``, ``dm_sampling_schedule``, per-seed ``seed_noise``,
``ddim_sample_loop`` over the cell's steps, the crop, ``.cpu()``) at the
cell's batch, without artifacts.

Checked: a sample of the window's windows, drawn from the seed, against the
float32 reference of the same seeds.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import common
from portbench.reference import loops, models as ref

SPANS = ("sample.batch", "sample.readback")


def setup(ctx):
    from sleepgen_torch.data.transforms import BORDER_PAD
    from sleepgen_torch.sample.sample_ldm import build_dm, dm_sampling_schedule
    from sleepgen_torch.sample.samplers import ddim_sample_loop, seed_noise

    spec, dev = ctx.spec, torch.device(ctx.device)
    (cfg,) = common.program_configs(ctx.cfg)
    unet = build_dm(cfg, common.to_numpy(common.unet_weights(ctx.cfg, ctx.seed, dev)), dev)
    sched = dm_sampling_schedule(cfg, ctx.cfg["diffusion"]["sample_table"], dev)
    window = cfg.unet.image_size

    def sample(seeds, steps):
        with torch.inference_mode():
            x_T = seed_noise(seeds, (window, 1), dev).transpose(1, 2)
            x = ddim_sample_loop(unet, sched, x_T, steps)
            return x[:, :, BORDER_PAD:-BORDER_PAD].transpose(1, 2)

    sample(list(range(spec["batch"])), spec["warm_steps"]).cpu()  # the timed shapes
    return {"sample": lambda seeds: sample(seeds, spec["steps"])}


def window(ctx, state):
    record = common.batch_loop(ctx, state["sample"], ctx.spec["batch"], ctx.spec["steps"])
    state["next_seed"] = record["next_seed"]
    return record


def profile(ctx, state):
    """One batch, as the window runs it, on seeds the window did not use."""
    from portbench.harness import span

    seeds = list(range(state["next_seed"], state["next_seed"] + ctx.spec["batch"]))
    with span("sample.batch"):
        out = state["sample"](seeds)
    with span("sample.readback"):
        out.cpu()
    return {"unet_forwards": ctx.spec["steps"], "batch": ctx.spec["batch"]}


def release(state):
    state.clear()


def reference_windows(cfg: dict, spec: dict, seed: int, seeds, device,
                      prec: ref.Precision | None = None) -> np.ndarray:
    """(N, 3000, 1) windows of ``seeds`` from the reference at ``prec``."""
    ref.set_fp32_math()
    unet = common.loaded(common.reference_unet(cfg, prec).to(device),
                         common.unet_weights(cfg, seed, device))
    d = cfg["diffusion"]
    acp = loops.alphas_cumprod(d["sample_schedule"], d["sample_table"], d["sample_beta_start"],
                               d["sample_beta_end"])

    def block(chunk):
        x = loops.seed_noise(chunk, 1, cfg["unet"]["image_size"]).to(device)
        with torch.no_grad():
            return loops.crop(loops.ddim(unet, acp, x, spec["steps"])).cpu().numpy()

    return common.in_blocks(block, list(seeds), spec["check_block"])


def check(ctx, record):
    return common.check_windows(ctx, record, reference_windows)


def control(ctx, record):
    return common.control_windows(ctx, reference_windows)
