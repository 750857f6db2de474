"""The readings that set a cell's limits, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> ... [--seconds s]
        [--numbers <name> ...] [--out <dir>]

For each seed, one run of the cell as the benchmark runs it
(a short window: its whole batches, steps or requests are the timed path
at the cell's sizes), the numbers its check compares (the program's
readings, the lower ones), the same numbers for the control (the
reference in fp8, one precision below the configuration's bf16, in the
program's place: the upper ones), and for training the planted faults'.
``--numbers`` reads numbers the driver can compare besides the cell's own.
One JSON line per reading on standard output, also appended to
``<out>/calibrate_<cell>.jsonl`` with ``--out <dir>``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def emit(out, name: str, obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        Path(out).mkdir(parents=True, exist_ok=True)
        with open(Path(out) / f"calibrate_{name}.jsonl", "a") as f:
            f.write(line + "\n")


def stats(err, norm) -> dict:
    """The worst, the median and the pooled (all windows' error norm over
    all windows' norm) relative gap, and the per-window gaps."""
    rel = sorted(e / n for e, n in zip(err, norm))
    pooled = math.sqrt(sum(e * e for e in err) / sum(n * n for n in norm))
    return {"worst": rel[-1], "median": rel[len(rel) // 2], "pooled": pooled, "rel": rel}


def readings(args) -> None:
    import torch

    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, seed, args.seconds, False, "cuda")
        ctx.spec["limits"] = {k: math.inf for k in [*ctx.spec["limits"], *args.numbers]}
        driver = harness.load_module("drivers", ctx.spec["driver"])
        result = harness.run_cell(ctx, t0, driver=driver)
        t1 = time.perf_counter()
        control = dict(driver.control(ctx, None))
        faults = ({k: dict(v) for k, v in driver.faults(ctx, None).items()}
                  if hasattr(driver, "faults") else {})
        emit(args.out, args.workload, {"cell": args.workload, "seed": seed,
                             "program": {k: v["value"] for k, v in result["checks"].items()},
                             "control": control, "faults": faults,
                             "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                             "windows": {k: stats(*v) for k, v in ctx.detail.items()},
                             "run_s": t1 - t0, "control_s": time.perf_counter() - t1})
        ctx.reference = None
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    harness.prepare_process()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[2**31 + 11])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--numbers", nargs="*", default=[])
    p.add_argument("--out", default=None, help="a directory to append the readings to")
    args = p.parse_args(argv)
    readings(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
