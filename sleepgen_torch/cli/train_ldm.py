"""CLI: stage-2 LDM training with the port.

The JAX package's flags (``sleepgen/cli/train_ldm.py``: --config_file,
--autoencoderkl_config_file_path, --best_model_path, the split CSVs,
--num_channels, --latent_channels, --spe, --dataset, --dtype) plus
--device. ``--best_model_path`` is the frozen AEKL's port run dir
(``params.npz``, a flat '/'-keyed parameter tree; the README shows how to
export one from a JAX run dir). Writes the run dir under the config's
``train.output_dir`` and prints its path, best loss and scale factor.
"""
from __future__ import annotations

import argparse
import ast


def parse_list(s):
    return ast.literal_eval(s) if isinstance(s, str) else s


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config_file", type=str, required=True)
    p.add_argument("--autoencoderkl_config_file_path", type=str, required=True)
    p.add_argument("--best_model_path", type=str, required=True,
                   help="AEKL port run dir holding params.npz")
    p.add_argument("--path_train_ids", type=str, required=True)
    p.add_argument("--path_valid_ids", type=str, required=True)
    p.add_argument("--path_pre_processed", type=str, required=True)
    p.add_argument("--num_channels", type=parse_list, default=None)
    p.add_argument("--latent_channels", type=int, default=None)
    p.add_argument("--spe", type=str, default="no-spectral")
    p.add_argument("--dataset", type=str, default="edfx")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None):
    from pathlib import Path

    from sleepgen_torch.config import Config
    from sleepgen_torch.data.dataset import load_split
    from sleepgen_torch.train.train_ldm import train_ldm
    from sleepgen_torch.utils.weights import aekl_state_from_jax, load_params_npz

    args = build_parser().parse_args(argv)

    from sleepgen_torch.utils.profiling import maybe_initialize_multihost


    maybe_initialize_multihost(args.device)
    cfg = Config.from_yaml(args.config_file)
    aekl_cfg = Config.from_yaml(args.autoencoderkl_config_file_path)
    if args.num_channels is not None:
        aekl_cfg.aekl.num_channels = list(args.num_channels)
    if args.latent_channels is not None:
        aekl_cfg.aekl.latent_channels = args.latent_channels
    cfg.spectral = args.spe == "spectral"
    cfg.dataset = args.dataset
    cfg.dtype = args.dtype

    train_ds = load_split(args.path_train_ids, args.path_pre_processed, args.dataset)
    valid_ds = load_split(args.path_valid_ids, args.path_pre_processed, args.dataset)
    ae_state = aekl_state_from_jax(load_params_npz(Path(args.best_model_path) / "params.npz"))
    result = train_ldm(cfg, train_ds, valid_ds, ae_state, aekl_cfg=aekl_cfg,
                       device=args.device)
    print(f"run_dir={result.run_dir} best_loss={result.best_loss:.6f} "
          f"scale_factor={result.scale_factor:.6f}")
    return result


if __name__ == "__main__":
    main()
