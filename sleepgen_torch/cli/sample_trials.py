"""CLI: generate synthetic EEG trials from an LDM with the port (DDIM or
DPM-Solver++(2M)).

Reads two port run dirs: the AEKL's (``config.yaml``, ``params.npz``) and
the LDM's (``config.yaml``, ``params.npz``, ``scale_factor.txt``).
``params.npz`` is a flat '/'-keyed parameter tree; the README shows how to
export one from a JAX run dir. Writes ``sample_{i}.npy`` and
``psd_list_{i}.npy`` under ``<output_dir>/samples_ldm_<lc>_<spe>_<dataset>``.
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
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None):
    from pathlib import Path

    from sleepgen_torch.config import Config
    from sleepgen_torch.sample.sample_ldm import sample_ldm_trials
    from sleepgen_torch.utils.weights import (aekl_state_from_jax, load_params_npz,
                                              unet_state_from_jax)

    args = build_parser().parse_args(argv)
    ae_dir, ldm_dir = Path(args.best_model_path), Path(args.diffusion_path)
    aekl_cfg = Config.from_yaml(ae_dir / "config.yaml")
    cfg = Config.from_yaml(ldm_dir / "config.yaml")
    if args.latent_channels is not None:
        aekl_cfg.aekl.latent_channels = args.latent_channels
    cfg.diffusion.num_inference_steps = args.num_inference_steps
    cfg.diffusion.sampler = args.sampler
    if cfg.unet.num_classes:
        raise SystemExit("conditional checkpoints (unet.num_classes > 0) are not "
                         "supported by the port yet")
    ae_state = aekl_state_from_jax(load_params_npz(ae_dir / "params.npz"))
    unet_state = unet_state_from_jax(load_params_npz(ldm_dir / "params.npz"))
    scale_factor = float((ldm_dir / "scale_factor.txt").read_text())

    lc = aekl_cfg.aekl.latent_channels
    type_dataset = args.type_dataset or cfg.dataset
    out = Path(args.output_dir) / f"samples_ldm_{lc}_{args.spe}_{type_dataset}"
    sigs = sample_ldm_trials(cfg, unet_state, ae_state, scale_factor, out,
                             start_seed=args.start_seed, stop_seed=args.stop_seed,
                             batch_size=args.batch_size, aekl_cfg=aekl_cfg,
                             compute_psd=not args.no_psd, device=args.device)
    print(f"wrote {sigs.shape[0]} samples to {out}")


if __name__ == "__main__":
    main()
