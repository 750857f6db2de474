"""Stage-1 training: ``train_aekl.make_train_step`` (the G step, then the D
step) at the batch of the configuration's AEKL YAML, on the AutoencoderKL
and the PatchDiscriminator with fp32 master weights and Adam at the
YAML's rates, computing in its dtype, as ``train_aekl.build_trainer``
composes them (from the seed's weights, not its initialiser). Set-up
prepares a pool of distinct batches (Gaussian windows whose scale rises
along the batch and alternates from row to row, cast to the compute dtype
as the trainer casts its batches, and the encoder's eps; ``step_inputs``);
the
window's steps cycle through it, timed, traced and read back as the
stage-2 cell's (``train.py``: ``window``, ``profile`` and ``release`` are
its).

Set-up drives the step through its first three batches: the G and D
losses of each, both networks' first gradients as Adam holds them after
step one, and their parameters after step three are kept. The check runs
the float32 reference (``reference/stage1.py``) over the same three
batches, the autoencoder in blocks of rows, and compares them as the
stage-2 cell does (``train.py``'s ``leaf_gap`` and ``row_gap``), each
network on its own, the worst of the two counted. ``control`` puts the
fp8 reference in the program's place; ``faults`` four faulty references:
the second half of each batch left out, every odd row left out, LSGAN
without its LeakyReLU, and the discriminator's BatchNorm on its running
statistics.
"""
from __future__ import annotations

import numpy as np
import torch
import yaml

from portbench import common, flops, harness, weights
from portbench.drivers import train as stage2
from portbench.reference import loops, models as ref, stage1

SPANS = stage2.SPANS
window, profile, release = stage2.window, stage2.profile, stage2.release
WEIGHTS_DISC = 7  # the discriminator's stream, after the purposes of weights.py
CHECKED_STEPS = 3
NETS = ("ae", "disc")


def settings(cfg: dict) -> dict:
    """The frozen AEKL YAML of the configuration (its last), as read."""
    return yaml.safe_load((harness.ROOT / cfg["yaml"][-1]).read_text())


def reference_disc(cfg: dict, prec: ref.Precision | None = None) -> stage1.PatchDiscriminator:
    d = settings(cfg)["discriminator"]
    return stage1.PatchDiscriminator(d["num_layers_d"], d["num_channels"], 1, 1,
                                     d["kernel_size"], prec)


def disc_weights(cfg: dict, seed: int, device) -> dict:
    """The discriminator's fp32 weights from the seed (BatchNorm weights
    1 + N(0, 0.01)), its running statistics 0 and 1."""
    with torch.device("meta"):
        disc = reference_disc(cfg)
    shapes = {k: tuple(p.shape) for k, p in disc.named_parameters()}
    bn = {f"{name}.{p}" for name, m in disc.named_modules()
          if isinstance(m, stage1.BatchNorm) for p in ("weight", "bias")}
    state = weights.make_state(shapes, bn, seed, device, WEIGHTS_DISC, served=False)
    for name, b in disc.named_buffers():
        state[name] = (torch.zeros if name.endswith("mean") else torch.ones)(b.shape,
                                                                              device=device)
    return state


def aekl_masters(cfg: dict, seed: int, device) -> dict:
    return common.seeded_weights(lambda: common.reference_aekl(cfg), seed, device,
                                 weights.WEIGHTS_AEKL, served=False)


def step_inputs(cfg: dict, seed: int, batch: int, i: int, device, dtype):
    """(x, eps) of pool entry ``i``: windows in ``dtype``, then the encoder's
    eps. Row r of the windows is N(0, a_r^2), its scale a_r rising
    log-uniformly from 1/4 to 4 along the batch and then halved on even
    rows and doubled on odd ones, 1/8 to 8 in all (the amplitudes of
    recorded windows differ by stage and by subject): iid rows of one scale
    give a gradient that half of the batch matches within bf16 rounding, so
    a step that left out a contiguous half, or every other row, would not
    show. Here the first half and the even rows each hold windows of a
    smaller scale than the batch's, the second half and the odd rows of a
    larger."""
    g = weights.generator(seed, device, weights.STEP_INPUTS, i)
    x = torch.randn((batch, 1, cfg["window"]), generator=g, device=device)
    parity = (torch.arange(batch, device=device) % 2) * 2.0 - 1.0
    scale = torch.logspace(-2.0, 2.0, batch, base=2.0, device=device) * 2.0 ** parity
    eps = torch.randn((batch, *stage2.latent_shape(cfg)), generator=g, device=device)
    return (x * scale[:, None, None]).to(dtype), eps


def step_flops(cfg: dict, batch: int) -> float:
    """One step of the reference on meta tensors at ``batch``: the G step
    (the autoencoder's forward and backward, the discriminator's forward and
    its input gradient) and the D step (two forwards, the parameters'
    gradient), without the blocks' recomputation."""
    with torch.device("meta"):
        ae, disc = common.reference_aekl(cfg), reference_disc(cfg)
        x = torch.empty(batch, 1, cfg["window"])
        eps = torch.empty(batch, *stage2.latent_shape(cfg))

    def step():
        disc.requires_grad_(False)
        recon, mu, sigma = stage1.reconstruct(ae, x, eps)
        ((recon - x).abs().mean() + stage1.kl_rows(mu, sigma).mean()
         + stage1.lsgan_rows(disc(recon), 1.0).mean()).backward()
        disc.requires_grad_(True)
        (stage1.lsgan_rows(disc(recon.detach()), 0.0).mean()
         + stage1.lsgan_rows(disc(x), 1.0).mean()).backward()

    return flops._count(step)


def setup(ctx):
    from sleepgen_torch.sample.sample_ldm import DTYPES
    from sleepgen_torch.train.train_aekl import build_models, make_train_step

    spec, dev, batch = ctx.spec, torch.device(ctx.device), ctx.spec["batch"]
    cfg = common.program_configs(ctx.cfg)[-1]
    dtype = DTYPES[cfg.dtype]
    with torch.device(dev):
        ae, disc = build_models(cfg)
    ae.load_state_dict(aekl_masters(ctx.cfg, ctx.seed, dev))
    disc.load_state_dict(disc_weights(ctx.cfg, ctx.seed, dev))
    opts = {"ae": torch.optim.Adam(ae.parameters(), lr=cfg.losses.optimizer_g_lr),
            "disc": torch.optim.Adam(disc.parameters(), lr=cfg.losses.optimizer_d_lr)}
    step = make_train_step(ae, disc, opts["ae"], opts["disc"], cfg, dtype)
    pool = [step_inputs(ctx.cfg, ctx.seed, batch, i, dev, dtype) for i in range(spec["pool"])]
    nets = {"ae": ae, "disc": disc}
    losses, grad1 = [], {}
    for i in range(CHECKED_STEPS):
        m = step(*pool[i])
        losses += [float(m["g_loss"]), float(m["disc_loss"])]
        if i == 0:
            for net in NETS:
                opt = opts[net]
                beta1 = opt.defaults["betas"][0]
                grad1.update({f"{net}.{k}": (opt.state[p].get("exp_avg", torch.zeros_like(p))
                                             / (1 - beta1)).cpu()
                              for k, p in nets[net].named_parameters()})
    params3 = {f"{net}.{k}": p.detach().to("cpu", copy=True)
               for net in NETS for k, p in nets[net].named_parameters()}
    for i in range(CHECKED_STEPS, spec["pool"]):  # every pool entry once before the window
        step(*pool[i])
    harness.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def loss(x, eps):
        m = step(x, eps)
        return m["g_loss"] + m["disc_loss"]  # non-finite if either is

    return {"step": loss, "pool": pool, "next": spec["pool"],
            "checked": {"loss": losses, "grad1": grad1, "params3": params3}}


def reference_steps(cfg: dict, seed: int, batch: int, block: int, device,
                    prec: ref.Precision | None = None, rows: slice = slice(None),
                    leaky: bool = True, running: bool = False) -> dict:
    """The reference's first three steps from the seed's weights on the
    pool's first three batches: the G and D losses of each, the first
    gradient of both networks and its parts by block of ``block`` rows,
    and the parameters after step three, by leaf (``ae.`` and ``disc.``).
    ``rows`` keeps only those rows of each batch; ``leaky`` and ``running``
    as ``stage1.train_step``'s."""
    ref.set_fp32_math()
    s = settings(cfg)
    losses = s["losses"]
    ae = common.reference_aekl(cfg, prec).to(device)
    ae.load_state_dict(aekl_masters(cfg, seed, device))
    disc = reference_disc(cfg, prec).to(device)
    disc.load_state_dict(disc_weights(cfg, seed, device))
    nets = {"ae": ae, "disc": disc}
    adams = {"ae": loops.Adam({k: p.data for k, p in ae.named_parameters()},
                              float(losses["optimizer_g_lr"])),
             "disc": loops.Adam({k: p.data for k, p in disc.named_parameters()},
                                float(losses["optimizer_d_lr"]))}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[s.get("dtype", cfg["dtype"])]
    out = {"loss": [], "grad1": None, "grad1_blocks": [], "params3": None}
    for i in range(CHECKED_STEPS):
        x, eps = step_inputs(cfg, seed, batch, i, device, dtype)
        blocks = [] if i == 0 else None
        g_loss, d_loss, g, d = stage1.train_step(
            ae, disc, x[rows].float(), eps[rows], float(losses["adv_weight"]),
            float(losses["kl_weight"]), block, leaky, running, blocks)
        if i == 0:
            out["grad1"] = {**{f"ae.{k}": v.cpu() for k, v in g.items()},
                            **{f"disc.{k}": v.cpu() for k, v in d.items()}}
            out["grad1_blocks"] = [{k: v.cpu() for k, v in b.items()} for b in blocks]
        adams["ae"].step(g)
        adams["disc"].step(d)
        out["loss"] += [g_loss, d_loss]
    out["params3"] = {f"{net}.{k}": p.detach().to("cpu", copy=True)
                      for net in NETS for k, p in nets[net].named_parameters()}
    return out


def split(leaves: dict, net: str) -> dict:
    return {k: v for k, v in leaves.items() if k.startswith(net + ".")}


def compare(cfg: dict, seed: int, got: dict, want: dict, device) -> dict:
    """The four compared numbers of ``got`` (the program's readings, or a
    stand-in's) against the reference's ``want``, each the worst of the
    two networks'."""
    theta0 = {**{f"ae.{k}": v.cpu() for k, v in aekl_masters(cfg, seed, device).items()},
              **{f"disc.{k}": v.cpu() for k, v in disc_weights(cfg, seed, device).items()}}
    out = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
           "grad1_leaf": 0.0, "change3_leaf": 0.0, "grad1_rows": 0.0}
    for net in NETS:
        g1 = split(want["grad1"], net)
        gn = {k: float(g.double().norm()) for k, g in g1.items()}
        med = float(np.median(list(gn.values())))
        moving = {k for k, v in gn.items() if v >= 1e-3 * med}
        change = {k: got["params3"][k] - theta0[k] for k in g1}
        ref_change = {k: want["params3"][k] - theta0[k] for k in g1}
        out["grad1_leaf"] = max(out["grad1_leaf"], stage2.leaf_gap(got["grad1"], g1))
        out["change3_leaf"] = max(out["change3_leaf"],
                                  stage2.leaf_gap(change, ref_change, moving))
        out["grad1_rows"] = max(out["grad1_rows"], stage2.row_gap(
            got["grad1"], g1, [split(b, net) for b in want["grad1_blocks"]]))
    return out


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
    """Four faulty references in the program's place: the second half of
    each batch, or its odd rows, left out (the mean over the rest), LSGAN on
    the raw logits, and BatchNorm on the running statistics."""
    spec = ctx.spec
    kinds = {"half_batch": {"rows": slice(0, spec["batch"] // 2)},
             "half_batch_strided": {"rows": slice(0, None, 2)},
             "lsgan_no_leaky": {"leaky": False}, "bn_running_stats": {"running": True}}
    return {name: list(compare(ctx.cfg, ctx.seed, reference_steps(
        ctx.cfg, ctx.seed, spec["batch"], spec["check_block"], ctx.device, **kw),
        ctx.reference, ctx.device).items()) for name, kw in kinds.items()}
