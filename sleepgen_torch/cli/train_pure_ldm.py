"""CLI: signal-space DM training with the port (``train-dm``).

The JAX package's flags (``sleepgen/cli/train_pure_ldm.py``: --config_file,
the split CSVs, --path_pre_processed, --spe (``spectral`` adds the 1e-6
Jukebox term), --dataset, --dtype) plus --device. Writes the run dir
under the config's ``train.output_dir`` and prints its path and best
loss; ``final_model/`` feeds ``impute``, ``best_model/`` ``sample-dm``.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config_file", type=str, required=True)
    p.add_argument("--path_train_ids", type=str, required=True)
    p.add_argument("--path_valid_ids", type=str, required=True)
    p.add_argument("--path_pre_processed", type=str, required=True)
    p.add_argument("--spe", type=str, default="no-spectral")
    p.add_argument("--dataset", type=str, default="edfx")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch versions")
    return p


def main(argv=None):
    from sleepgen_torch.config import Config
    from sleepgen_torch.data.dataset import load_split
    from sleepgen_torch.train.train_dm import train_dm

    args = build_parser().parse_args(argv)

    from sleepgen_torch.utils.profiling import maybe_initialize_multihost


    maybe_initialize_multihost(args.device)
    cfg = Config.from_yaml(args.config_file)
    cfg.spectral = args.spe == "spectral"
    cfg.dataset = args.dataset
    cfg.dtype = args.dtype

    train_ds = load_split(args.path_train_ids, args.path_pre_processed, args.dataset)
    valid_ds = load_split(args.path_valid_ids, args.path_pre_processed, args.dataset)
    result = train_dm(cfg, train_ds, valid_ds, device=args.device)
    print(f"run_dir={result.run_dir} best_loss={result.best_loss:.6f}")
    return result


if __name__ == "__main__":
    main()
