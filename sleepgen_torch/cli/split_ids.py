"""CLI: subject-level 60/20/20 split of an ids CSV (the reference's
``src/preprocessing/split_train_valid_test_sleep_edfx.py``), written as
``<ids>_train.csv``, ``<ids>_valid.csv`` and ``<ids>_test.csv`` with the
``csv`` module. The JAX CLI's multi-host start-up and compilation cache
have no counterpart here.
"""
from __future__ import annotations

import argparse

from sleepgen_torch.data.splits import write_splits


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ids_csv", type=str, required=True)
    args = p.parse_args(argv)
    from sleepgen_torch.utils.profiling import maybe_initialize_multihost

    maybe_initialize_multihost(device="cpu")
    write_splits(args.ids_csv)
    print("Done")


if __name__ == "__main__":
    main()
