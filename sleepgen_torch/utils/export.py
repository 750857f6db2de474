"""Run export: a portable directory with a JSON manifest, the run's
artifacts and the final parameters as one flat ``.npz``.

The port's copy of ``sleepgen/utils/export.py`` (the reference's mlflow
surface). ``final_model.npz`` holds the model under the JAX package's
flax names, flattened with ``'/'`` (``weights.unet_state_to_jax`` or
``weights.aekl_state_to_jax`` of a port state dict makes that tree), so an
export of either package loads in the other: ``load_exported_params``
returns the nested tree, which ``weights.unet_state_from_jax`` (or the
AEKL's) turns into a port state dict.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

ARTIFACT_SUFFIXES = (".yaml", ".jsonl", ".npy", ".pdf", ".tsv", ".json", ".png")


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {'a/b/c': ndarray}, keys sorted at each level;
    tensor leaves become numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    if hasattr(tree, "items"):
        for k, v in sorted(tree.items()):
            out.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        leaf = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
        out[prefix.rstrip("/")] = leaf
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{'a/b/c': ndarray} -> the nested mapping."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def export_run(run_dir: str | Path, export_dir: Optional[str | Path] = None,
               params: Any = None, metrics: Optional[Dict[str, float]] = None) -> Path:
    """Bundle a run: ``manifest.json``, ``artifacts/`` (the run dir's files
    with an artifact suffix) and, when ``params`` (a flax-named tree) is
    given, ``final_model.npz``. Returns the export dir (default
    ``run_dir/export``)."""
    run_dir = Path(run_dir)
    export_dir = Path(export_dir or (run_dir / "export"))
    export_dir.mkdir(parents=True, exist_ok=True)
    artifacts = export_dir / "artifacts"
    artifacts.mkdir(exist_ok=True)
    copied = []
    for p in run_dir.iterdir():
        if p.is_file() and p.suffix in ARTIFACT_SUFFIXES:
            shutil.copy2(p, artifacts / p.name)
            copied.append(p.name)
    if params is not None:
        np.savez(export_dir / "final_model.npz", **flatten_params(params))
    manifest = {"run_dir": str(run_dir), "exported_at": time.time(),
                "artifacts": sorted(copied), "has_model": params is not None,
                "metrics": metrics or {}}
    (export_dir / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return export_dir


def load_exported_params(export_dir: str | Path) -> Dict[str, Any]:
    """``final_model.npz`` -> the nested flax-named tree."""
    with np.load(Path(export_dir) / "final_model.npz") as z:
        return unflatten_params({k: z[k] for k in z.files})
