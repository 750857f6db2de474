"""Synthetic sleep-EEG recordings, so training runs without downloads.

The port's own copy of ``sleepgen/data/synthetic.py``: sinusoid mixtures
in the delta (0.5-4 Hz), theta (4.1-8) and alpha (8.1-12) bands plus 1/f
noise, at about 50 uV (raw EDF scale, before the x1e6 step). The same
seed gives the same recording as the JAX package. ``write_synthetic_npy_tree``
lays them out as the reference's ``.npy`` tree and returns the rows of its
ids CSV; ``write_ids_csv`` writes such rows with the ``csv`` module.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

BANDS = {"delta": (0.5, 4.0), "theta": (4.1, 8.0), "alpha": (8.1, 12.0)}
ID_COLUMNS = ("FILE_NAME_EEG", "subject", "night", "age", "gender", "LightsOff")


def pink_noise(rng: np.random.Generator, n: int, sfreq: float = 100.0) -> np.ndarray:
    """Unit-variance 1/f noise by spectral shaping."""
    spec = rng.normal(size=n // 2 + 1) + 1j * rng.normal(size=n // 2 + 1)
    freqs = np.fft.rfftfreq(n, d=1.0 / sfreq)
    freqs[0] = freqs[1]
    x = np.fft.irfft(spec / np.sqrt(freqs), n=n)
    return x / np.std(x)


def synthetic_recording(seed: int, duration_s: float = 120.0, sfreq: float = 100.0,
                        amplitude_v: float = 50e-6) -> np.ndarray:
    """One raw-scale recording (T,) float64, in volts."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * sfreq)
    t = np.arange(n) / sfreq
    x = np.zeros(n)
    for lo, hi in BANDS.values():
        for _ in range(3):
            f = rng.uniform(lo, hi)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.3, 1.0)
            x += amp * np.sin(2 * np.pi * f * t + phase)
    x += 0.8 * pink_noise(rng, n, sfreq)
    return x / np.max(np.abs(x)) * amplitude_v


def make_synthetic_dataset(n_recordings: int = 16, duration_s: float = 120.0,
                           seed: int = 0) -> List[np.ndarray]:
    return [synthetic_recording(seed * 10_000 + i, duration_s) for i in range(n_recordings)]


def write_synthetic_npy_tree(out_dir: str | Path, n_subjects: int = 8,
                             nights: Sequence[int] = (1, 2), duration_s: float = 120.0,
                             seed: int = 0) -> List[Dict[str, object]]:
    """One ``{name}.npy`` of shape (1, T) per (subject, night), as the
    reference's EDF conversion writes them; returns the ids rows."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for subject in range(n_subjects):
        for night in nights:
            rec = synthetic_recording(seed * 10_000 + len(rows), duration_s)
            name = f"SC4{subject:02d}{night}E0-Fpz-Cz"
            np.save(out_dir / f"{name}.npy", rec[None, :])
            rows.append({"FILE_NAME_EEG": name, "subject": subject, "night": night,
                         "age": 30 + subject, "gender": "F" if subject % 2 else "M",
                         "LightsOff": "22:00"})
    return rows


def write_ids_csv(path: str | Path, rows: Sequence[Dict[str, object]]) -> Path:
    """Write ids rows as a split CSV (the columns of ``ID_COLUMNS``)."""
    path = Path(path)
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=ID_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)
    return path
