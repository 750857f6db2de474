"""Windowed EEG dataset and loader.

The port's own copy of ``sleepgen/data/dataset.py``: a CSV of recording
ids names per-recording ``.npy`` files; recordings are normalized once
and held in host memory; each epoch draws one random window per recording
(the crop is the only per-step randomness) with a ``numpy.random.Generator``,
exactly as the JAX package does, so the same seed gives the same windows.
The split CSVs are read with the ``csv`` module and windows are gathered
with numpy. Batches are (B, L, 1) float32 arrays, the JAX package's
layout; the final batch may be short (drop_last=False), or padded with
copies of its last window to a multiple of the data-parallel ranks
(``pad_multiple``), as the JAX loader pads to its devices.
"""
from __future__ import annotations

import csv
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

from sleepgen_torch.data import transforms as T


@dataclass
class WindowDataset:
    """Normalized recordings and the windowing around them."""

    recordings: List[np.ndarray]  # each (T,) float32 in [0, 1]
    names: List[str] = field(default_factory=list)
    window: int = T.WINDOW_SIZE
    pad: int = T.BORDER_PAD

    def __post_init__(self):
        if not self.names:
            self.names = [f"rec_{i}" for i in range(len(self.recordings))]
        self.lengths = np.array([len(r) for r in self.recordings])
        if (self.lengths < self.window).any():
            raise ValueError(f"a recording is shorter than the {self.window}-sample window")

    def __len__(self) -> int:
        return len(self.recordings)

    @property
    def padded_window(self) -> int:
        return self.window + 2 * self.pad

    @classmethod
    def from_raw(cls, raws: Sequence[np.ndarray], names: Optional[List[str]] = None,
                 **kw) -> "WindowDataset":
        return cls(recordings=[T.normalize_recording(r) for r in raws],
                   names=list(names or []), **kw)

    @classmethod
    def from_csv(cls, csv_path: str | Path, basepath: str | Path,
                 dataset: str = "edfx", **kw) -> "WindowDataset":
        """The reference's CSV contract: column FILE_NAME_EEG names
        ``{basepath}/{name}.npy`` (edfx appends ``.npy``, other datasets
        give the file name whole)."""
        suffix = ".npy" if dataset == "edfx" else ""
        with open(csv_path, newline="") as fh:
            names = [row["FILE_NAME_EEG"] for row in csv.DictReader(fh)]
        raws = [np.load(Path(basepath) / f"{name}{suffix}") for name in names]
        return cls.from_raw(raws, names, **kw)

    def epoch_windows(self, rng: np.random.Generator) -> np.ndarray:
        """One random window per recording -> (N, L_padded, 1) float32."""
        starts = T.random_starts(rng, self.lengths, self.window)
        out = np.empty((len(self), self.padded_window, 1), np.float32)
        for i, (rec, s) in enumerate(zip(self.recordings, starts)):
            out[i, :, 0] = T.crop_and_pad(rec, s, self.window, self.pad)
        return out

    def epoch_batches(self, batch_size: int, rng: np.random.Generator,
                      shuffle: bool = False, pad_multiple: int = 1) -> Iterator[np.ndarray]:
        """The epoch's windows in batches of ``batch_size`` (the last may be
        shorter, or padded to ``pad_multiple``); ``shuffle`` permutes them
        with the same generator."""
        from sleepgen_torch.parallel.mesh import pad_to_multiple

        wins = self.epoch_windows(rng)
        idx = np.arange(len(wins))
        if shuffle:
            rng.shuffle(idx)
        for i in range(0, len(idx), batch_size):
            yield pad_to_multiple(wins[idx[i:i + batch_size]], pad_multiple)


def load_split(ids_csv: str | Path, basepath: str | Path,
               dataset: str = "edfx") -> WindowDataset:
    return WindowDataset.from_csv(ids_csv, basepath, dataset)
