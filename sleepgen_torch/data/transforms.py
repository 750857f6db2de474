"""Window constants, per-recording preprocessing, crops and layout converters.

The port's own copy of ``sleepgen/data/transforms.py`` (the reference's
MONAI chain ScaleIntensity(factor=1e6) -> ScaleIntensity(0, 1) ->
RandSpatialCrop(3000) -> BorderPad(36)). Windows are 30 s at 100 Hz (3000
samples), padded by 36 samples on each side to 3072 for the models. Both
intensity steps are affine per recording, so they commute with the crop
and run once per recording at load time. The port's public functions use
the JAX package's (B, L, C) layout; the reference's ``.npy`` artifacts
are (B, C, L).
"""
from __future__ import annotations

import numpy as np

SFREQ = 100
WINDOW_SIZE = 30 * SFREQ  # 3000
BORDER_PAD = 36
PADDED_SIZE = WINDOW_SIZE + 2 * BORDER_PAD  # 3072


def normalize_recording(raw: np.ndarray, factor: float = 1e6) -> np.ndarray:
    """x (1 + factor) (MONAI's ScaleIntensity(factor)), then min-max to
    [0, 1] over the recording. Input (T,) or (1, T); output (T,) float32."""
    x = np.asarray(raw, dtype=np.float64).reshape(-1) * (1.0 + factor)
    lo, hi = x.min(), x.max()
    if hi == lo:
        return np.zeros_like(x, dtype=np.float32)
    return ((x - lo) / (hi - lo)).astype(np.float32)


def random_starts(rng: np.random.Generator, lengths: np.ndarray,
                  window: int = WINDOW_SIZE) -> np.ndarray:
    """Crop offsets, one per recording, uniform over the valid positions."""
    return (rng.random(len(lengths)) * (lengths - window + 1)).astype(np.int64)


def crop_and_pad(rec: np.ndarray, start: int, window: int = WINDOW_SIZE,
                 pad: int = BORDER_PAD) -> np.ndarray:
    """One (window + 2 pad,) window of a normalized recording, zero-padded."""
    return np.pad(rec[start:start + window], (pad, pad))


def center_crop_valid(x: np.ndarray, pad: int = BORDER_PAD) -> np.ndarray:
    """Drop the border pad along L of (..., L, C), or of a 1-D array."""
    return x[..., pad:-pad, :] if x.ndim >= 2 else x[pad:-pad]


def to_blc(x: np.ndarray) -> np.ndarray:
    """(B, C, L) reference layout -> (B, L, C)."""
    return np.ascontiguousarray(np.swapaxes(x, -1, -2))


def to_bcl(x: np.ndarray) -> np.ndarray:
    """(B, L, C) -> (B, C, L) for ``.npy`` artifact parity."""
    return np.ascontiguousarray(np.swapaxes(x, -1, -2))
