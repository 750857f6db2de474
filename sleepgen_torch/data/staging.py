"""Labelled 30 s epochs for class-conditional diffusion training.

The port's own copy of ``LabeledEpochDataset`` from
``sleepgen/data/staging.py``. Where ``WindowDataset`` draws a random
window from each whole recording, a conditional model trains on the
stage-aligned epochs themselves: windows (N, 3000, C) with labels (N,),
edge-padded once to 3072 (``transforms.BORDER_PAD`` on each side), so the
same UNet geometry serves both. ``epoch_batches`` yields ``(x, y)``: x
(B, 3072, C) float32 in the JAX package's layout, y (B,) int32.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from sleepgen_torch.data import transforms as T


class LabeledEpochDataset:
    def __init__(self, windows: np.ndarray, labels: np.ndarray):
        if len(windows) != len(labels):
            raise ValueError(f"{len(windows)} windows but {len(labels)} labels")
        if windows.ndim == 2:
            windows = windows[..., None]
        self.windows = np.pad(windows.astype(np.float32),
                              ((0, 0), (T.BORDER_PAD, T.BORDER_PAD), (0, 0)), mode="edge")
        self.labels = labels.astype(np.int32)

    def __len__(self) -> int:
        return len(self.windows)

    @property
    def padded_window(self) -> int:
        return self.windows.shape[1]

    def epoch_batches(self, batch_size: int, rng: np.random.Generator,
                      shuffle: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The epoch's (windows, labels) in batches of ``batch_size`` (the
        last may be shorter), permuted by ``rng`` when ``shuffle``."""
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        for i in range(0, len(idx), batch_size):
            sel = idx[i:i + batch_size]
            yield self.windows[sel], self.labels[sel]
