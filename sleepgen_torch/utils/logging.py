"""Run dirs and the JSONL metrics stream.

The port's own copy of ``sleepgen/utils/logging.py``: a run dir is
resumed when it holds ``checkpoints/``; metrics go to one append-only
``metrics_{split}.jsonl`` per split, one JSON object per line with the
step, the wall-clock time and the scalars.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Tuple


def setup_run_dir(output_dir: str | Path, run_name: str) -> Tuple[Path, bool]:
    """Create or reopen ``output_dir/run_name``; resume iff it holds checkpoints."""
    run_dir = Path(output_dir) / run_name
    resume = (run_dir / "checkpoints").exists()
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir, resume


class MetricsLogger:
    """Append-only JSONL scalar stream of one split."""

    def __init__(self, run_dir: str | Path, split: str = "train"):
        self.path = Path(run_dir) / f"metrics_{split}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()


class NullLogger:
    """A ``MetricsLogger`` that writes nothing: a data-parallel rank other
    than 0 logs through it."""

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


def split_loggers(run_dir: str | Path, main: bool):
    """(train, val) loggers of ``run_dir``; ``NullLogger``s unless ``main``."""
    if not main:
        return NullLogger(), NullLogger()
    return MetricsLogger(run_dir, "train"), MetricsLogger(run_dir, "val")
