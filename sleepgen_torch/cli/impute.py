"""CLI: fill a masked span of 30 s windows by RePaint with the port
(``impute``).

Two modes, chosen by the checkpoints given:

- **signal-space DM** (default): ``--diffusion_path`` is a ``train-dm`` run
  dir, whose ``final_model/`` is read (or a port run dir holding
  ``params.npz`` itself); the chain runs at the full signal length
  (``samplers.impute_dm``).
- **latent LDM**: ``--best_model_path`` is a ``train-aekl`` run dir and
  ``--diffusion_path`` a ``train-ldm`` run dir; the ``best_model/`` of each
  (or a port run dir given itself) and the LDM's ``scale_factor.txt`` are
  read; the chain runs in the 4x shorter latent space and the observed
  samples are spliced back exactly in signal space
  (``samplers.impute_ldm``).

Counterpart of ``sleepgen/cli/impute.py``, with its flags plus --device.
Input: a ``.npy`` of windows (N, 3000), (N, 1, 3000) or (N, 3000, C) in
the pipeline's normalised units. Each window is edge-padded to the
checkpoint's 3072 samples; the mask is 0 on ``[mask_start,
mask_start + mask_len)`` and 1 elsewhere, the padding included. Windows
run in batches of ``--batch_size``, the last padded with copies of its
last window. The models compute in their config's dtype. The noise of the
batch starting at window i comes from ``torch.Generator`` seeded from
``SeedSequence([seed, i])`` on the device (the JAX CLI folds i into
``PRNGKey(seed)``, which torch cannot reproduce). Output:
``imputed.npy`` (N, C, 3000) and ``mask.npy`` (3000,) bool, True where
observed.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", type=str, required=True, help=".npy of windows to repair")
    p.add_argument("--diffusion_path", type=str, required=True,
                   help="trained diffusion run dir (train-dm, or train-ldm with "
                        "--best_model_path)")
    p.add_argument("--best_model_path", type=str, default=None,
                   help="trained AEKL run dir (train-aekl, or a port run dir): switches to "
                        "latent-space (LDM) imputation")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--mask_start", type=int, required=True,
                   help="first masked sample (0..2999, 100 Hz)")
    p.add_argument("--mask_len", type=int, required=True)
    p.add_argument("--stage", type=int, default=None,
                   help="stage label for conditional checkpoints")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="classifier-free guidance for the repair (>1 needs a conditional "
                        "checkpoint trained with cond_dropout_prob > 0)")
    p.add_argument("--num_resample", type=int, default=1,
                   help="RePaint resampling count (boundary harmonisation)")
    p.add_argument("--latent_erode", type=int, default=4,
                   help="LDM mode: latent anchor-mask erosion, in latent positions per side")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None):
    from pathlib import Path

    import numpy as np
    import torch

    from sleepgen_torch.data.transforms import BORDER_PAD
    from sleepgen_torch.nn.layers import set_fast_math
    from sleepgen_torch.sample.sample_ldm import (build_dm, build_models, model_dir,
                                                  read_model_dir, read_run_dirs,
                                                  stage_labels)
    from sleepgen_torch.sample.samplers import impute_dm, impute_ldm, validate_stage
    from sleepgen_torch.train.common import make_generator
    from sleepgen_torch.train.train_ldm import make_schedule
    from sleepgen_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    latent_mode = args.best_model_path is not None
    dev = resolve_device(args.device)
    if latent_mode:
        cfg, aekl_cfg, unet_state, ae_state, scale_factor = read_run_dirs(
            model_dir(args.best_model_path, "best_model"),
            model_dir(args.diffusion_path, "best_model"))
    else:
        cfg, unet_state = read_model_dir(args.diffusion_path, "final_model")
    try:
        validate_stage(cfg.num_classes, args.stage, args.guidance_scale)
    except ValueError as e:
        raise SystemExit(str(e))

    x = np.load(args.input)
    if x.ndim == 2:  # (N, L)
        x = x[..., None]
    elif x.ndim == 3 and x.shape[1] == 1 and x.shape[2] > x.shape[1]:
        x = np.transpose(x, (0, 2, 1))  # (N, 1, L) -> (N, L, 1)
    n, length, _ = x.shape

    if latent_mode:
        unet, ae = build_models(cfg, unet_state, ae_state, dev, aekl_cfg)
        # cfg.image_size is the latent length: the signal window is it
        # times 2 per AEKL downsampling
        window = cfg.image_size * 2 ** (len(aekl_cfg.aekl.num_channels) - 1)
    else:
        unet = build_dm(cfg, unet_state, dev)
        window = cfg.image_size
    set_fast_math(unet, False)  # the JAX CLI's UNet takes no fast_math
    if length + 2 * BORDER_PAD != window:
        raise SystemExit(f"window length {length} + 2*{BORDER_PAD} pad must equal the "
                         f"checkpoint's signal window {window}")
    if not (0 <= args.mask_start < length and args.mask_len > 0):
        raise SystemExit(f"mask [{args.mask_start}, +{args.mask_len}) outside 0..{length - 1}")
    stop = min(args.mask_start + args.mask_len, length)

    x_pad = np.pad(x.astype(np.float32), ((0, 0), (BORDER_PAD, BORDER_PAD), (0, 0)),
                   mode="edge").transpose(0, 2, 1)  # (N, C, window)
    mask = np.ones((1, 1, window), np.float32)  # 1 = observed
    mask[..., BORDER_PAD + args.mask_start:BORDER_PAD + stop] = 0.0
    mask_t = torch.from_numpy(mask).to(dev)
    sched = make_schedule(cfg, dev)
    bs = args.batch_size
    labels = stage_labels(args.stage, bs, dev) if cfg.num_classes > 0 else None

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = []
    for i in range(0, n, bs):
        xb = x_pad[i:i + bs]
        real = len(xb)
        if real < bs:  # every batch runs at the same shapes
            xb = np.concatenate([xb, np.repeat(xb[-1:], bs - real, 0)])
        xb = torch.from_numpy(np.ascontiguousarray(xb)).to(dev)
        noise = make_generator(args.seed, dev, i)
        with torch.inference_mode():
            if latent_mode:
                fixed = impute_ldm(unet, ae, scale_factor, sched, xb, mask_t, noise, labels,
                                   args.num_resample, args.latent_erode, args.guidance_scale)
            else:
                fixed = impute_dm(unet, sched, xb, mask_t, noise, labels, args.num_resample,
                                  args.guidance_scale)
        outs.append(fixed.cpu().numpy()[:real])
    imputed = np.concatenate(outs)[..., BORDER_PAD:-BORDER_PAD]
    np.save(out_dir / "imputed.npy", imputed)
    np.save(out_dir / "mask.npy", mask[0, 0, BORDER_PAD:-BORDER_PAD].astype(bool))
    print(f"imputed {n} windows ([{args.mask_start}:{stop}) regenerated) "
          f"-> {out_dir / 'imputed.npy'}")


if __name__ == "__main__":
    main()
