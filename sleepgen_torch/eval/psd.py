"""DPSS multitaper power spectral density, the PSD of the sample artifacts.

Counterpart of ``sleepgen/eval/psd.py::multitaper_psd`` (MNE
``psd_array_multitaper`` defaults: half-bandwidth 4, low-bias taper
selection at eigenvalue > 0.9, non-adaptive eigenvalue weights, DC
removal, 'length' normalisation), on the host in float64 numpy with
scipy's DPSS tapers.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from sleepgen_torch.data.transforms import SFREQ


@functools.lru_cache(maxsize=8)
def dpss_tapers(n_times: int, half_nbw: float = 4.0,
                low_bias: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """DPSS tapers (unit energy) and their concentration eigenvalues,
    selected as MNE does: int(2 * half_nbw) tapers, then with ``low_bias``
    those with eigenvalue > 0.9 (at least the best one)."""
    from scipy.signal.windows import dpss

    tapers, ratios = dpss(n_times, half_nbw, Kmax=int(2 * half_nbw),
                          return_ratios=True)
    if low_bias:
        keep = ratios > 0.9
        if not keep.any():
            keep = np.zeros_like(keep)
            keep[np.argmax(ratios)] = True
        tapers, ratios = tapers[keep], ratios[keep]
    return tapers.astype(np.float64), ratios.astype(np.float64)


def multitaper_psd(x: np.ndarray, sfreq: float = float(SFREQ), fmin: float = 0.0,
                   fmax: float | None = 18.0) -> Tuple[np.ndarray, np.ndarray]:
    """x (..., T) -> (psd (..., F), freqs (F,)) with inclusive [fmin, fmax]."""
    x = np.asarray(x, np.float64)
    n_times = x.shape[-1]
    tapers, eigvals = dpss_tapers(n_times)
    x = x - x.mean(axis=-1, keepdims=True)
    spec = np.fft.rfft(x[..., None, :] * tapers, axis=-1)  # (..., K, F)
    sq = spec.real**2 + spec.imag**2
    sq[..., 0] *= 0.5
    if n_times % 2 == 0:
        sq[..., -1] *= 0.5
    psd = 2.0 * np.tensordot(sq, eigvals, axes=([-2], [0])) / eigvals.sum()
    freqs = np.fft.rfftfreq(n_times, d=1.0 / sfreq)
    lo = int(np.searchsorted(freqs, fmin, side="left"))
    hi = int(np.searchsorted(freqs, fmax, side="right")) if fmax is not None else len(freqs)
    return psd[..., lo:hi], freqs[lo:hi]


def multitaper_psd_db(x: np.ndarray, sfreq: float = float(SFREQ),
                      fmax: float = 18.0) -> Tuple[np.ndarray, np.ndarray]:
    """dB multitaper PSD (10 log10, floored at 1e-30), float32 like the
    JAX package's artifacts."""
    psd, freqs = multitaper_psd(x, sfreq=sfreq, fmax=fmax)
    psd_db = 10.0 * np.log10(np.maximum(psd, 1e-30))
    return psd_db.astype(np.float32), freqs.astype(np.float32)
