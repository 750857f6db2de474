"""EEG frequency bands and their zero-phase band-pass filter.

Counterpart of ``sleepgen/eval/bands.py``, the reference's per-band eval
(delta 0.5-4 Hz, theta 4.1-8, alpha 8.1-12, filtered before MS-SSIM and
FID): a Hamming-window sinc FIR band-pass designed on the host, applied
along L of a (B, C, L) tensor after reflect padding by ``numtaps // 2``,
as one valid depthwise convolution on the tensor's device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sleepgen_torch.data.transforms import SFREQ

EEG_BANDS: Dict[str, Tuple[float, float]] = {
    "delta": (0.5, 4.0),
    "theta": (4.1, 8.0),
    "alpha": (8.1, 12.0),
}


def firwin_bandpass(l_freq: float, h_freq: float, sfreq: float = float(SFREQ),
                    numtaps: int = 401) -> np.ndarray:
    """Band-pass taps (odd count): the difference of two sinc low-passes
    times numpy's symmetric ``np.hamming``, scaled to unit gain at the
    band's centre."""
    if numtaps % 2 != 1:
        raise ValueError(f"numtaps must be odd, got {numtaps}")
    n = np.arange(numtaps) - (numtaps - 1) / 2

    def sinc_lp(fc):
        return np.sinc(2 * fc / sfreq * n) * 2 * fc / sfreq

    h = (sinc_lp(h_freq) - sinc_lp(l_freq)) * np.hamming(numtaps)
    fc = (l_freq + h_freq) / 2
    gain = np.abs(np.sum(h * np.exp(-2j * np.pi * fc / sfreq * np.arange(numtaps))))
    return (h / gain).astype(np.float32)


def filter_band(x: torch.Tensor, band: str | Tuple[float, float],
                sfreq: float = float(SFREQ), numtaps: int = 401) -> torch.Tensor:
    """Band-pass (B, C, L) along L in fp32, zero-phase: the centred FIR
    over the reflect-padded signal; same shape out."""
    lo, hi = EEG_BANDS[band] if isinstance(band, str) else band
    h = torch.as_tensor(firwin_bandpass(lo, hi, sfreq, numtaps), device=x.device)
    pad = numtaps // 2
    c = x.shape[1]
    xp = F.pad(x.float(), (pad, pad), mode="reflect")
    return F.conv1d(xp, h.view(1, 1, -1).expand(c, 1, -1), groups=c)
