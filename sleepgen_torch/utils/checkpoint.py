"""Checkpoints of a training run, and the run dirs its best models become.

The port's counterpart of ``sleepgen/utils/checkpoint.py`` (orbax there):
``save`` keeps the last ``KEEP`` full training states (step,
parameters, Adam state, EMA, best loss, scale factor) as
``checkpoints/step_{step:08d}.pt`` with ``torch.save``; ``restore_latest``
reads the newest. ``save_best`` writes ``best_model/`` or
``final_model/`` as a port run dir: ``config.yaml`` and ``params.npz``
(the model in the JAX package's flax-tree keys), plus
``scale_factor.txt`` for an LDM. ``python -m sleepgen_torch sample``
reads both kinds; ``train-ldm --best_model_path`` reads an AEKL's.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import torch

from sleepgen_torch.config import Config
from sleepgen_torch.utils.weights import save_params_npz


KEEP = 3  # periodic checkpoints kept, as the JAX package keeps


class CheckpointManager:
    def __init__(self, run_dir: str | Path):
        self.run_dir = Path(run_dir).resolve()
        self.dir = self.run_dir / "checkpoints"
        self.dir.mkdir(parents=True, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.dir.glob("step_*.pt"))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Mapping[str, Any]) -> None:
        """Write the state and drop all but the newest ``KEEP``; the file
        appears whole or not at all. ``restore_latest`` maps it to the CPU."""
        path = self.dir / f"step_{step:08d}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self._steps()[:-KEEP]:
            (self.dir / f"step_{old:08d}.pt").unlink()

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        step = self.latest_step
        if step is None:
            return None
        return torch.load(self.dir / f"step_{step:08d}.pt", map_location="cpu",
                          weights_only=True)

    def save_best(self, params: Mapping[str, Any], cfg: Optional[Config],
                  name: str = "best_model", scale_factor: Optional[float] = None) -> Path:
        """Write ``run_dir/name`` as a port run dir: ``params`` is the
        model's flax parameter tree (``weights.unet_state_to_jax`` or
        ``aekl_state_to_jax`` of its state dict); ``cfg`` goes to
        ``config.yaml`` (the first-generation trainers have none);
        ``scale_factor`` (an LDM's) goes to ``scale_factor.txt`` when
        given."""
        path = self.run_dir / name
        if path.exists():
            shutil.rmtree(path)
        path.mkdir()
        if cfg is not None:
            cfg.to_yaml(path / "config.yaml")
        save_params_npz(path / "params.npz", params)
        if scale_factor is not None:
            (path / "scale_factor.txt").write_text(repr(float(scale_factor)))
        return path
