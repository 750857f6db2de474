"""CLI: stage-1 AEKL training with the port.

The JAX package's flags (``sleepgen/cli/train_autoencoderkl.py``:
--config_file, the split CSVs, --path_pre_processed, --num_channels,
--spe, --latent_channels, --dataset, --dtype) plus --device. Writes the
run dir under the config's ``train.output_dir`` and prints its path, best
loss and whether the run stopped on a non-finite loss; its
``best_model/`` is a port AEKL run dir for ``train-ldm --best_model_path``
and ``sample --best_model_path``.
"""
from __future__ import annotations

import argparse
import ast


def parse_list(s):
    return ast.literal_eval(s) if isinstance(s, str) else s


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config_file", type=str, required=True)
    p.add_argument("--path_train_ids", type=str, required=True)
    p.add_argument("--path_valid_ids", type=str, required=True)
    p.add_argument("--path_pre_processed", type=str, required=True)
    p.add_argument("--num_channels", type=parse_list, default=None)
    p.add_argument("--spe", type=str, default="no-spectral",
                   choices=["spectral", "no-spectral"])
    p.add_argument("--latent_channels", type=int, default=None)
    p.add_argument("--dataset", type=str, default="edfx", choices=["edfx", "shhs", "shhsh"])
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None):
    from sleepgen_torch.config import Config
    from sleepgen_torch.data.dataset import load_split
    from sleepgen_torch.train.train_aekl import train_aekl

    args = build_parser().parse_args(argv)

    from sleepgen_torch.utils.profiling import maybe_initialize_multihost


    maybe_initialize_multihost(args.device)
    cfg = Config.from_yaml(args.config_file)
    if args.num_channels is not None:
        cfg.aekl.num_channels = list(args.num_channels)
    if args.latent_channels is not None:
        cfg.aekl.latent_channels = args.latent_channels
    cfg.spectral = args.spe == "spectral"
    cfg.dataset = args.dataset
    cfg.dtype = args.dtype

    train_ds = load_split(args.path_train_ids, args.path_pre_processed, args.dataset)
    valid_ds = load_split(args.path_valid_ids, args.path_pre_processed, args.dataset)
    result = train_aekl(cfg, train_ds, valid_ds, device=args.device)
    print(f"run_dir={result.run_dir} best_loss={result.best_loss:.6f} "
          f"nan_stop={result.stopped_on_nan}")
    return result


if __name__ == "__main__":
    main()
