"""Umbrella CLI: ``python -m sleepgen_torch <command> [args...]``."""
from __future__ import annotations

import sys

COMMANDS = {
    "sample": "sleepgen_torch.cli.sample_trials",
    "compute-fid": "sleepgen_torch.cli.compute_fid",
    "compute-mmds": "sleepgen_torch.cli.compute_mmds",
    "train-aekl": "sleepgen_torch.cli.train_autoencoderkl",
    "train-ldm": "sleepgen_torch.cli.train_ldm",
    "train-dm": "sleepgen_torch.cli.train_pure_ldm",
    "sample-dm": "sleepgen_torch.cli.sample_trials_ddpm",
    "serve": "sleepgen_torch.cli.serve",
    "warm-cache": "sleepgen_torch.cli.warm_cache",
    "impute": "sleepgen_torch.cli.impute",
    "sample-ae": "sleepgen_torch.cli.sample_trials_autoencoder",
    "band-eval": "sleepgen_torch.cli.band_eval",
    "decode": "sleepgen_torch.cli.run_sleep_decode",
    "convert-edfx": "sleepgen_torch.cli.convert_edfx",
    "convert-shhs": "sleepgen_torch.cli.convert_shhs",
    "split-ids": "sleepgen_torch.cli.split_ids",
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m sleepgen_torch <command> [args...]\ncommands:")
        for k in COMMANDS:
            print(f"  {k}")
        return 0 if len(sys.argv) >= 2 else 2
    cmd = sys.argv.pop(1)
    if cmd not in COMMANDS:
        print(f"unknown command '{cmd}'", file=sys.stderr)
        return 2
    import importlib

    return importlib.import_module(COMMANDS[cmd]).main()


if __name__ == "__main__":
    sys.exit(main())
