"""Window constants and layout converters.

Windows are 30 s at 100 Hz (3000 samples), padded by 36 samples on each
side to 3072 for the models. The port's public functions use the JAX
package's (B, L, C) layout; the reference's ``.npy`` artifacts are
(B, C, L).
"""
from __future__ import annotations

import numpy as np

SFREQ = 100
BORDER_PAD = 36


def to_blc(x: np.ndarray) -> np.ndarray:
    """(B, C, L) reference layout -> (B, L, C)."""
    return np.ascontiguousarray(np.swapaxes(x, -1, -2))


def to_bcl(x: np.ndarray) -> np.ndarray:
    """(B, L, C) -> (B, C, L) for ``.npy`` artifact parity."""
    return np.ascontiguousarray(np.swapaxes(x, -1, -2))
