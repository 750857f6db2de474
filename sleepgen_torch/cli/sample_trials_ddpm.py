"""CLI: signal-space DM sampling with the port (``sample-dm``): per-seed
noise (1, 1, 3072), DDIM over the DM's UNet, crop, artifacts.

The JAX package's flags (``sleepgen/cli/sample_trials_ddpm.py``) plus
--device, with its table-length quirk: ``--num_inference_steps`` is the
length of the scaled-linear v-prediction table (the reference passes it
as the DDIM scheduler's ``num_train_timesteps``; default 1000) and
``--num_ddim_steps`` the loop's length (default 200, clamped to the
table's). So ``--num_inference_steps 200`` steps a 200-entry table 200
times, a different trajectory from the default 1000-entry table stepped
200 times. For a class-conditional checkpoint ``--stage k`` samples stage
k, with ``--guidance_scale`` for classifier-free guidance.

``--diffusion_path`` is a port run dir (``config.yaml``, ``params.npz``),
or a ``train-dm`` run dir, whose ``best_model/`` is then read. Writes
``sample_{i}.npy`` and ``psd_list_{i}.npy`` under
``<output_dir>/samples_ddpm_<spe>_<dataset>``, with ``_stage<k>``
appended for a conditional checkpoint.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--diffusion_path", type=str, required=True)
    p.add_argument("--start_seed", type=int, default=0)
    p.add_argument("--stop_seed", type=int, default=1000)
    p.add_argument("--num_inference_steps", type=int, default=1000,
                   help="sampling beta-table length (the reference's DDIMScheduler "
                        "num_train_timesteps)")
    p.add_argument("--num_ddim_steps", type=int, default=200,
                   help="DDIM loop length (the reference's set_timesteps(200))")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--spe", type=str, default="no-spectral")
    p.add_argument("--type_dataset", type=str, default="")
    p.add_argument("--no_psd", action="store_true")
    p.add_argument("--stage", type=int, default=None,
                   help="sleep-stage label for class-conditional checkpoints "
                        "(config.unet.num_classes>0); artifacts land in a "
                        "stage-suffixed directory. Omit for unconditional.")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="classifier-free guidance scale (conditional checkpoints "
                        "trained with train.cond_dropout_prob>0)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None):
    from pathlib import Path

    from sleepgen_torch.sample.sample_ldm import read_model_dir, sample_dm_trials
    from sleepgen_torch.sample.samplers import validate_stage

    args = build_parser().parse_args(argv)

    from sleepgen_torch.utils.profiling import maybe_initialize_multihost


    maybe_initialize_multihost(args.device)
    cfg, unet_state = read_model_dir(args.diffusion_path, "best_model")
    try:
        validate_stage(cfg.unet.num_classes, args.stage, args.guidance_scale)
    except ValueError as e:
        raise SystemExit(str(e))

    type_dataset = args.type_dataset or cfg.dataset
    suffix = f"_stage{args.stage}" if cfg.unet.num_classes > 0 else ""
    out = Path(args.output_dir) / f"samples_ddpm_{args.spe}_{type_dataset}{suffix}"
    sigs = sample_dm_trials(cfg, unet_state, out, start_seed=args.start_seed,
                            stop_seed=args.stop_seed, batch_size=args.batch_size,
                            num_train_timesteps=args.num_inference_steps,
                            num_ddim_steps=args.num_ddim_steps, compute_psd=not args.no_psd,
                            device=args.device, stage=args.stage,
                            guidance_scale=args.guidance_scale)
    print(f"wrote {sigs.shape[0]} samples to {out}")


if __name__ == "__main__":
    main()
