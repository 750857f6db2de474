"""CLI: generate synthetic EEG trials from an LDM with the port (DDIM or
DPM-Solver++(2M)), unconditional or, for a class-conditional checkpoint,
of one sleep stage (``--stage``) with optional classifier-free guidance
(``--guidance_scale``).

Reads two port run dirs: the AEKL's (``config.yaml``, ``params.npz``) and
the LDM's (``config.yaml``, ``params.npz``, ``scale_factor.txt``).
``params.npz`` is a flat '/'-keyed parameter tree; the README shows how to
export one from a JAX run dir. Writes ``sample_{i}.npy`` and
``psd_list_{i}.npy`` under ``<output_dir>/samples_ldm_<lc>_<spe>_<dataset>``,
with ``_stage<N>`` appended for a conditional checkpoint.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--best_model_path", type=str, required=True, help="AEKL run dir")
    p.add_argument("--diffusion_path", type=str, required=True, help="LDM run dir")
    p.add_argument("--start_seed", type=int, default=0)
    p.add_argument("--stop_seed", type=int, default=1000)
    p.add_argument("--num_inference_steps", type=int, default=200)
    p.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "dpm++2m"],
                   help="dpm++2m reaches DDIM-200's quality in about 20 steps")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--spe", type=str, default="no-spectral")
    p.add_argument("--latent_channels", type=int, default=None)
    p.add_argument("--type_dataset", type=str, default="")
    p.add_argument("--no_psd", action="store_true")
    p.add_argument("--stage", type=int, default=None,
                   help="sleep-stage label for class-conditional checkpoints "
                        "(the denoiser's num_classes > 0); artifacts land in a "
                        "stage-suffixed directory. Omit for unconditional.")
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="classifier-free guidance scale (conditional "
                        "checkpoints trained with train.cond_dropout_prob>0)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None):
    from pathlib import Path

    from sleepgen_torch.sample.sample_ldm import read_run_dirs, sample_ldm_trials
    from sleepgen_torch.sample.samplers import validate_stage

    args = build_parser().parse_args(argv)

    from sleepgen_torch.utils.profiling import maybe_initialize_multihost


    maybe_initialize_multihost(args.device)
    cfg, aekl_cfg, unet_state, ae_state, scale_factor = read_run_dirs(
        args.best_model_path, args.diffusion_path)
    if args.latent_channels is not None:
        aekl_cfg.aekl.latent_channels = args.latent_channels
    cfg.diffusion.num_inference_steps = args.num_inference_steps
    cfg.diffusion.sampler = args.sampler
    try:
        validate_stage(cfg.num_classes, args.stage, args.guidance_scale)
    except ValueError as e:
        raise SystemExit(str(e))

    lc = aekl_cfg.aekl.latent_channels
    type_dataset = args.type_dataset or cfg.dataset
    suffix = f"_stage{args.stage}" if cfg.num_classes > 0 else ""
    out = Path(args.output_dir) / f"samples_ldm_{lc}_{args.spe}_{type_dataset}{suffix}"
    sigs = sample_ldm_trials(cfg, unet_state, ae_state, scale_factor, out,
                             start_seed=args.start_seed, stop_seed=args.stop_seed,
                             batch_size=args.batch_size, aekl_cfg=aekl_cfg,
                             compute_psd=not args.no_psd, device=args.device,
                             stage=args.stage, guidance_scale=args.guidance_scale)
    print(f"wrote {sigs.shape[0]} samples to {out}")


if __name__ == "__main__":
    main()
