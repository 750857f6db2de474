"""Recording ingest: filter, resample, crop; MNE-free, pure numpy.

The port's own copy of ``sleepgen/data/ingest.py``:

* ``convert_edfx_recording`` (``src/preprocessing/convert_edfx.py:38-66``):
  read an EDF, crop to +-30 min around the scored sleep, FIR low-pass at
  18 Hz, save one (1, T) ``.npy`` per EEG channel and the annotations;
* ``lowpass_fir``, ``resample_fft`` and ``map_shhs_stages`` for the SHHS
  ingest (``convert_shhs.py:77-123``).

Filtering follows MNE's default design (Hamming-window FIR, zero-phase,
transition bandwidth min(max(h_freq / 4, 2 Hz), rate / 2 - h_freq));
resampling is FFT resampling with ``scipy.signal.resample``'s semantics,
MNE's default.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from sleepgen_torch.data.edf import read_edf


def _odd(n: int) -> int:
    return n if n % 2 == 1 else n + 1


def lowpass_fir(x: np.ndarray, h_freq: float, sfreq: float) -> np.ndarray:
    """Zero-phase Hamming FIR low-pass, MNE-style automatic length:
    filter_length = 3.3 / trans_bw * sfreq, trans_bw = min(max(0.25*h, 2),
    nyq - h)."""
    nyq = sfreq / 2.0
    trans_bw = min(max(h_freq * 0.25, 2.0), nyq - h_freq)
    numtaps = _odd(int(round(3.3 / trans_bw * sfreq)))
    n = np.arange(numtaps) - (numtaps - 1) / 2
    fc = h_freq + trans_bw / 2.0  # cutoff at the middle of the transition
    h = np.sinc(2 * fc / sfreq * n) * 2 * fc / sfreq
    h *= np.hamming(numtaps)
    h /= h.sum()  # unity DC gain
    pad = numtaps // 2
    xp = np.pad(x, pad, mode="reflect")
    return np.convolve(xp, h, mode="valid")


def resample_fft(x: np.ndarray, sfreq: float, target_sfreq: float) -> np.ndarray:
    """FFT-domain resampling (scipy.signal.resample semantics)."""
    if sfreq == target_sfreq:
        return x
    n_out = int(round(len(x) * target_sfreq / sfreq))
    xf = np.fft.rfft(x)
    nf_out = n_out // 2 + 1
    yf = np.zeros(nf_out, dtype=complex)
    k = min(len(xf), nf_out)
    yf[:k] = xf[:k]
    return np.fft.irfft(yf, n=n_out) * (n_out / len(x))


# Sleep-EDFx annotation descriptions -> sleep flag
SLEEP_STAGES = {"1", "2", "3", "4", "R"}


def crop_to_sleep_period(
    x: np.ndarray,
    sfreq: float,
    annotations: List[Tuple[float, float, str]],
    crop_wake_mins: float = 30.0,
) -> Tuple[np.ndarray, float]:
    """Crop ±crop_wake_mins around the first/last scored sleep event
    (convert_edfx.py:44-49: description last char in {1,2,3,4,R})."""
    onsets = [a[0] for a in annotations if a[2] and a[2][-1] in SLEEP_STAGES]
    if not onsets:
        return x, 0.0
    tmin = max(min(onsets) - crop_wake_mins * 60.0, 0.0)
    tmax = min(max(onsets) + crop_wake_mins * 60.0, len(x) / sfreq)
    i0, i1 = int(round(tmin * sfreq)), int(round(tmax * sfreq)) + 1
    return x[i0:i1], tmin


SHHS_STAGE_MAP = {0: 0, 1: 1, 2: 2, 3: 3, 4: 3, 5: 4}  # convert_shhs.py:86-92


def map_shhs_stages(labels: np.ndarray) -> np.ndarray:
    return np.vectorize(lambda l: SHHS_STAGE_MAP.get(int(l), int(l)))(labels)


def convert_edfx_recording(
    psg_path: str | Path,
    hyp_path: Optional[str | Path],
    out_dir: str | Path,
    h_freq: float = 18.0,
    crop_wake_mins: float = 30.0,
    eeg_only: bool = True,
) -> Dict[str, Path]:
    """One Sleep-EDFx PSG -> per-channel (1, T) .npy files, reproducing the
    reference output contract (convert_edfx.py:51-66)."""
    psg = read_edf(psg_path)
    annotations = psg.annotations
    if hyp_path is not None:
        annotations = read_edf(hyp_path).annotations

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written: Dict[str, Path] = {}
    stem = Path(psg_path).stem

    if annotations:
        np.save(out_dir / f"{stem}-annotation.npy",
                np.asarray(annotations, dtype=object), allow_pickle=True)

    for i, sig in enumerate(psg.signals):
        label = sig.label
        if eeg_only and not label.startswith("EEG"):
            continue
        name = label.replace("EEG ", "")
        sfreq = psg.sfreq(i)
        x = psg.data[i]
        x, _ = crop_to_sleep_period(x, sfreq, annotations, crop_wake_mins)
        x = lowpass_fir(x, h_freq, sfreq)
        path = out_dir / f"{stem}-{name}.npy"
        np.save(path, x[None, :])
        written[name] = path
    return written
