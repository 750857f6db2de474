"""Power spectral densities of the sample artifacts, on the host in float64 numpy.

Counterpart of ``sleepgen/eval/psd.py``:

* ``multitaper_psd``: MNE ``psd_array_multitaper`` defaults (half-bandwidth
  4, low-bias taper selection at eigenvalue > 0.9, non-adaptive eigenvalue
  weights, DC removal, 'length' normalisation) with scipy's DPSS tapers;
  the reference's artifact PSD.
* ``welch_psd``: a Hamming / 256 / 50 % Welch periodogram (scipy's
  defaults), density scaling, for the PSD health metrics.

The ``*_db`` helpers give 10 log10 of the PSD, floored at 1e-30, in fp32.
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


def welch_psd(x: np.ndarray, sfreq: float = float(SFREQ), nperseg: int = 256,
              noverlap: int = 128, fmax: float | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """x (..., T) -> (psd (..., F), freqs (F,)) in V^2/Hz: segments of
    ``nperseg`` samples every ``nperseg - noverlap``, each less its mean
    and times a periodic Hamming window (scipy's ``get_window``, not
    numpy's symmetric one); the one-sided spectrum doubles every bin but DC
    and, for an even ``nperseg``, Nyquist; frequencies up to ``fmax``
    inclusive."""
    x = np.asarray(x, np.float64)
    nperseg = min(nperseg, x.shape[-1])
    noverlap = min(noverlap, nperseg - 1)
    step = nperseg - noverlap
    n_segments = (x.shape[-1] - noverlap) // step
    idx = np.arange(nperseg)[None, :] + step * np.arange(n_segments)[:, None]
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
    segs = x[..., idx]  # (..., n_segments, nperseg)
    spec = np.fft.rfft((segs - segs.mean(axis=-1, keepdims=True)) * win, axis=-1)
    p = (spec.real**2 + spec.imag**2) / (sfreq * np.sum(win**2))
    p[..., 1:-1 if nperseg % 2 == 0 else None] *= 2.0
    psd = p.mean(axis=-2)
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / sfreq)
    if fmax is not None:
        keep = int(np.searchsorted(freqs, fmax, side="right"))
        psd, freqs = psd[..., :keep], freqs[:keep]
    return psd, freqs


def _db(psd: np.ndarray, freqs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    psd_db = 10.0 * np.log10(np.maximum(psd, 1e-30))
    return psd_db.astype(np.float32), freqs.astype(np.float32)


def welch_psd_db(x: np.ndarray, sfreq: float = float(SFREQ),
                 fmax: float = 18.0) -> Tuple[np.ndarray, np.ndarray]:
    """dB Welch PSD, fp32."""
    return _db(*welch_psd(x, sfreq=sfreq, fmax=fmax))


def multitaper_psd_db(x: np.ndarray, sfreq: float = float(SFREQ),
                      fmax: float = 18.0) -> Tuple[np.ndarray, np.ndarray]:
    """dB multitaper PSD (10 log10, floored at 1e-30), float32 like the
    JAX package's artifacts."""
    return _db(*multitaper_psd(x, sfreq=sfreq, fmax=fmax))
