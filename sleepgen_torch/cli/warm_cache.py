"""Warm a machine for a configuration before traffic: build the kernels,
then run each target once on seeded weights.

What persists: only the kernels' library. ``kernels/_build.py`` compiles
``sleepgen_torch/csrc`` with ``nvcc`` into ``sleepgen_torch/_build/`` at
first use, and every later process (``serve``, ``sample``, the trainers)
loads it from there. So the command first builds the library, or loads it
if it is on disk.

What does not persist: cuDNN's algorithm choices, K2's weight tiles
(``kernels/fused_resblock.py``) and PyTorch's caching allocator all live
in the process. The runs of the targets still show, before any traffic,
that the card, the library and each path work at the configuration's
shapes: a failure raises. A service warms its own process with
``SamplerService.warmup``.

Targets, each at each ``--batch_sizes`` (samplers) or ``--train_batch``
(train steps), with one ``warmed <label>: <s>`` line per call:

- ``aekl``: one stage-1 train step (AEKL and discriminator, both Adams);
- ``ldm``: one stage-2 train step (with labels, and the label dropout of
  ``train.cond_dropout_prob``, for a conditional config);
- ``sampler``: the DDIM sampler at the config's step count, plus decode;
- ``dpm``: DPM++2M at the config's step count if it samples with it,
  else at 20 steps.

A conditional config (the denoiser's ``num_classes`` > 0) runs each sampler at
stage 0, plain and then guided.

Usage:
  python -m sleepgen_torch warm-cache --config_file config.yaml \\
      [--targets aekl,ldm,sampler,dpm] [--batch_sizes 64,128] [--device cuda]
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config_file", type=str, default=None,
                   help="run/train config YAML (defaults to the flagship config)")
    p.add_argument("--targets", type=str, default="aekl,ldm,sampler",
                   help="comma list: aekl,ldm,sampler,dpm")
    p.add_argument("--batch_sizes", type=str, default="64",
                   help="sampler seed-batch sizes to warm")
    p.add_argument("--train_batch", type=int, default=None,
                   help="train-step batch (default: config batch size)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None) -> None:
    import torch

    from sleepgen_torch.config import Config
    from sleepgen_torch.kernels import _build
    from sleepgen_torch.sample.sample_ldm import (DTYPES, build_aekl, build_models, build_unet,
                                                  make_ldm_sampler, sampling_schedule,
                                                  stage_labels)
    from sleepgen_torch.train import common as C
    from sleepgen_torch.utils.device import resolve_device
    from sleepgen_torch.utils.weights import seeded_state_dict

    args = build_parser().parse_args(argv)
    cfg = Config.from_yaml(args.config_file) if args.config_file else Config()
    targets = set(args.targets.split(","))
    unknown = targets - {"aekl", "ldm", "sampler", "dpm"}
    if unknown:
        raise SystemExit(f"unknown targets {sorted(unknown)}; use aekl,ldm,sampler,dpm")
    conditional = cfg.num_classes > 0
    batches = [int(b) for b in args.batch_sizes.split(",")]
    dev = resolve_device(args.device)
    dtype = DTYPES[cfg.dtype]
    # the signal geometry of the config: latent length x 2^(AEKL downsamplings)
    window = cfg.image_size * 2 ** (len(cfg.aekl.num_channels) - 1)
    in_ch, lc = cfg.aekl.in_channels, cfg.aekl.latent_channels
    train_batch = args.train_batch or cfg.train.batch_size
    gen = C.make_generator(cfg.train.seed, dev)

    def clock(label, fn):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"warmed {label}: {time.perf_counter() - t0:.1f}s", flush=True)

    if dev.type == "cuda":
        clock("kernel library", _build.load)

    def windows(batch):
        return torch.rand((batch, in_ch, window), generator=gen, device=dev)

    if "aekl" in targets:
        from sleepgen_torch.train import train_aekl as A

        ae, disc, opt_g, opt_d = A.build_trainer(cfg, dev)
        step = A.make_train_step(ae, disc, opt_g, opt_d, cfg, dtype)
        x = windows(train_batch).to(dtype)
        eps = torch.randn((train_batch, lc, C.latent_length(cfg, window)), generator=gen,
                          device=dev)
        clock(f"aekl train step batch {train_batch}", lambda: step(x, eps))
        del ae, disc, opt_g, opt_d, step, x, eps

    with torch.device("meta"):
        ae_state = seeded_state_dict(build_aekl(cfg), cfg.train.seed + 1)
    if "ldm" in targets:
        from sleepgen_torch.train import train_ldm as T

        unet, ae, sched, opt = T.build_trainer(cfg, ae_state, cfg, dev)
        step = T.make_ldm_train_step(unet, ae, sched, opt, 1.0, dtype)
        x = windows(train_batch)
        inputs = T.draw_step_inputs(gen, train_batch, (lc, C.latent_length(cfg, window)),
                                    sched.num_timesteps)
        if conditional:
            labels = torch.arange(train_batch, device=dev) % cfg.num_classes
            inputs += (labels, C.draw_label_drop(gen, train_batch, cfg.train.cond_dropout_prob))
        clock(f"ldm train step batch {train_batch}", lambda: step(x, *inputs))
        del unet, ae, sched, opt, step, x, inputs

    kinds = [(name, kind, steps) for name, kind, steps in (
        ("sampler", "ddim", cfg.diffusion.num_inference_steps),
        ("dpm", "dpm++2m", cfg.diffusion.num_inference_steps
         if cfg.diffusion.sampler == "dpm++2m" else 20)) if name in targets]
    if not kinds:
        return
    with torch.device("meta"):
        unet_state = seeded_state_dict(build_unet(cfg, lc, lc), cfg.train.seed)
    unet, ae = build_models(cfg, unet_state, ae_state, dev)
    sched = sampling_schedule(cfg, dev)
    for _, kind, steps in kinds:
        for guided in (False, True) if conditional else (False,):
            s = make_ldm_sampler(unet, ae, sched, cfg.image_size, lc, steps,
                                 sampler=kind, device=dev, conditional=conditional,
                                 guided=guided)
            for b in batches:
                labels = stage_labels(0, b, dev) if conditional else None
                scale = 2.0 if guided else None
                label = f"{kind}-{steps} {'guided ' if guided else ''}sampler batch {b}"
                clock(label, lambda: s(1.0, range(b), labels, scale).cpu())


if __name__ == "__main__":
    main()
