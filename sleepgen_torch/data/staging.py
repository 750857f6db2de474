"""Sleep-stage epoching for downstream decoding, and labelled epochs for
class-conditional diffusion.

The port's own copy of ``sleepgen/data/staging.py`` (the reference's
braindecode/skorch stack, ``src/testing/run_sleep_decode.py:97-156``):

* ``windows_from_annotations``: 30 s windows cut from stage annotations
  with the AASM mapping (W -> 0, 1 -> 1, 2 -> 2, 3 and 4 -> 3, R -> 4);
* ``standard_scale_windows``: per-window, per-channel standard scaling;
* ``sequence_indices`` and ``center_label``: braindecode's
  ``SequenceSampler``, non-overlapping runs of 3 windows within a
  recording, labelled by the centre window;
* ``balanced_class_weights``: sklearn's 'balanced' class weights;
* ``make_synthetic_staged``: staged synthetic EEG with realistic class
  overlap, so the decoders run without downloads;
* ``LabeledEpochDataset``: the epochs a conditional diffusion model trains
  on.

Each returns the same arrays as the JAX package's function for the same
inputs and seed.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from sleepgen_torch.data import transforms as T
from sleepgen_torch.data.synthetic import pink_noise

STAGE_MAPPING: Dict[str, int] = {
    "Sleep stage W": 0,
    "Sleep stage 1": 1,
    "Sleep stage 2": 2,
    "Sleep stage 3": 3,
    "Sleep stage 4": 3,
    "Sleep stage R": 4,
}
STAGE_NAMES = ["Wake", "N1", "N2", "N3", "REM"]


def windows_from_annotations(
    signal: np.ndarray,
    sfreq: float,
    annotations: Sequence[Tuple[float, float, str]],
    mapping: Dict[str, int] = STAGE_MAPPING,
    window_size_s: float = 30.0,
    t_offset: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, window, C) float32 epochs and (N,) int64 labels cut from stage
    annotations (onset_s, duration_s, description). A long annotation
    (Sleep-EDFx hypnograms span many epochs) gives consecutive 30 s
    windows, as braindecode's create_windows_from_events with stride ==
    size; windows that run off the signal are dropped. ``t_offset``:
    seconds already cropped off the signal's start."""
    if signal.ndim == 1:
        signal = signal[:, None]
    win = int(round(window_size_s * sfreq))
    xs, ys = [], []
    for onset, duration, desc in annotations:
        if desc not in mapping:
            continue
        label = mapping[desc]
        start = onset - t_offset
        for k in range(max(int(duration // window_size_s), 1)):
            i0 = int(round((start + k * window_size_s) * sfreq))
            i1 = i0 + win
            if i0 < 0 or i1 > len(signal):
                continue
            xs.append(signal[i0:i1])
            ys.append(label)
    if not xs:
        return np.empty((0, win, signal.shape[1]), np.float32), np.empty((0,), np.int64)
    return np.stack(xs).astype(np.float32), np.asarray(ys, np.int64)


def standard_scale_windows(x: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance per window and channel of x (N, T, C)
    (sklearn's scale; a constant channel is only centred)."""
    mu = x.mean(axis=1, keepdims=True)
    sd = x.std(axis=1, keepdims=True)
    return ((x - mu) / np.where(sd == 0, 1.0, sd)).astype(np.float32)


def sequence_indices(rec_ids: np.ndarray, n_windows: int = 3, stride: int = 3) -> np.ndarray:
    """(M, n_windows) indices of runs of ``n_windows`` consecutive windows
    within one recording, starting every ``stride`` windows."""
    out: List[np.ndarray] = []
    for rid in np.unique(rec_ids):
        idx = np.flatnonzero(rec_ids == rid)
        for s in range(0, len(idx) - n_windows + 1, stride):
            out.append(idx[s:s + n_windows])
    return np.stack(out) if out else np.empty((0, n_windows), np.int64)


def center_label(labels: np.ndarray, seq_idx: np.ndarray) -> np.ndarray:
    """The label of each sequence's centre window."""
    return labels[seq_idx[:, seq_idx.shape[1] // 2]]


def balanced_class_weights(y: np.ndarray, n_classes: int = 5) -> np.ndarray:
    """sklearn's ``compute_class_weight('balanced')``: n / (k count_c) over
    the k classes present; an absent class weighs 0. float32."""
    counts = np.bincount(y, minlength=n_classes).astype(np.float64)
    present = counts > 0
    w = np.zeros(n_classes)
    w[present] = len(y) / (present.sum() * counts[present])
    return w.astype(np.float32)


# Markov stage-transition matrix (rows: W, N1, N2, N3, REM), loosely the
# empirical Sleep-EDFx hypnogram statistics: sleep is sticky, N1 is a hub,
# direct W<->N3 jumps are rare.
_STAGE_TRANSITIONS = np.array([
    # W     N1    N2    N3    REM
    [0.75, 0.19, 0.03, 0.00, 0.03],   # W
    [0.12, 0.45, 0.33, 0.02, 0.08],   # N1
    [0.03, 0.07, 0.72, 0.12, 0.06],   # N2
    [0.01, 0.02, 0.18, 0.77, 0.02],   # N3
    [0.05, 0.10, 0.07, 0.00, 0.78],   # REM
])
# the stages a scorer confuses each stage with, for label noise
_CONFUSABLE = {0: [1], 1: [0, 4, 2], 2: [1, 3], 3: [2], 4: [1]}
# the hypnogram descriptions of W, N1, N2, N3 and REM
STAGE_DESCRIPTIONS = ["Sleep stage W", "Sleep stage 1", "Sleep stage 2",
                       "Sleep stage 3", "Sleep stage R"]


def _stage_epoch(rng: np.random.Generator, stage: int, t: np.ndarray,
                 subj: Dict[str, float]) -> np.ndarray:
    """One 30 s epoch of stage-conditioned synthetic EEG on a shared 1/f
    background: W alpha bursts and fast activity, N1 theta with residual
    alpha, N2 theta with spindles and K-complexes, N3 delta, REM theta with
    sawtooth-like bursts. The draws are the JAX package's, in its order."""
    def tone(freq, amp, jitter=0.05):
        f = freq * (1.0 + jitter * rng.normal())
        return amp * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))

    def burst(freq, amp, dur_s, center_s):
        env = np.exp(-0.5 * ((t - center_s) / (dur_s / 2.0)) ** 2)
        return amp * env * np.sin(2 * np.pi * freq * t + rng.uniform(0, 2 * np.pi))

    x = 1.4 * pink_noise(rng, len(t))
    if stage == 0:
        for _ in range(rng.integers(1, 4)):
            x += burst(subj["alpha"], rng.uniform(0.35, 0.7),
                       rng.uniform(2.0, 6.0), rng.uniform(0, 30))
        x += tone(22.0, 0.18, 0.2) + tone(30.0, 0.12, 0.2)
        x += tone(subj["theta"], 0.2)
    elif stage == 1:
        x += tone(subj["theta"], 0.45) + tone(subj["alpha"], 0.2)
        x += tone(0.4, 0.2, 0.3)
    elif stage == 2:
        x += tone(subj["theta"], 0.4) + tone(subj["delta"], 0.3)
        for _ in range(rng.integers(1, 3)):
            x += burst(subj["spindle"], rng.uniform(0.5, 0.9),
                       rng.uniform(0.5, 1.0), rng.uniform(1, 29))
        if rng.random() < 0.6:
            x += burst(1.2, rng.uniform(1.2, 2.0), 1.0, rng.uniform(2, 28))
    elif stage == 3:
        x += tone(subj["delta"], 1.0) + tone(subj["delta"] * 1.9, 0.4)
        x += tone(subj["theta"], 0.3)
        if rng.random() < 0.3:
            x += burst(subj["spindle"], rng.uniform(0.3, 0.5),
                       rng.uniform(0.4, 0.8), rng.uniform(1, 29))
    else:
        x += tone(subj["theta"] * 1.05, 0.5)
        for _ in range(rng.integers(0, 3)):
            x += burst(3.0, rng.uniform(0.2, 0.45),
                       rng.uniform(1.0, 3.0), rng.uniform(0, 30))
        x += tone(subj["alpha"], 0.08)
    return subj["gain"] * x


def make_synthetic_staged(
    n_recordings: int = 24,
    n_epochs_per_rec: int = 40,
    sfreq: int = 100,
    seed: int = 0,
    label_noise: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(windows (N, 3000, 1) standard-scaled float32, labels (N,),
    recording ids (N,)): the shape contract of the ``decode`` CLI's
    ``load_staged_dataset``, without downloads. Each recording has a
    subject's gain and peak frequencies, stages follow the sticky Markov
    chain ``_STAGE_TRANSITIONS``, and ``label_noise`` of the labels are
    flipped to a confusable stage, as scorers disagree; decoders land
    between chance (0.2) and 1.0."""
    rng = np.random.default_rng(seed)
    t = np.arange(30 * sfreq, dtype=np.float64) / sfreq
    xs, ys, rids = [], [], []
    for rec in range(n_recordings):
        subj = {
            "gain": float(np.exp(0.3 * rng.normal())),
            "alpha": float(rng.normal(10.0, 0.3)),
            "theta": float(rng.normal(5.5, 0.25)),
            "delta": float(rng.uniform(0.8, 1.6)),
            "spindle": float(rng.normal(13.0, 0.35)),
        }
        sig, anns = [], []
        s = int(rng.integers(0, 5))
        for i in range(n_epochs_per_rec):
            s = int(rng.choice(5, p=_STAGE_TRANSITIONS[s]))
            sig.append(_stage_epoch(rng, s, t, subj))
            anns.append((i * 30.0, 30.0, STAGE_DESCRIPTIONS[s]))
        x, y = windows_from_annotations(np.concatenate(sig), sfreq, anns)
        flip = rng.random(len(y)) < label_noise
        y = y.copy()
        for j in np.flatnonzero(flip):
            y[j] = rng.choice(_CONFUSABLE[int(y[j])])
        xs.append(standard_scale_windows(x))
        ys.append(y)
        rids.append(np.full(len(y), rec))
    return np.concatenate(xs), np.concatenate(ys), np.concatenate(rids)


class LabeledEpochDataset:
    """Labelled 30 s epochs: windows (N, 3000, C) with labels (N,),
    edge-padded once to 3072 (``transforms.BORDER_PAD`` on each side), so
    the unconditional UNet geometry serves a conditional model.
    ``epoch_batches`` yields ``(x, y)``: x (B, 3072, C) float32 in the JAX
    package's layout, y (B,) int32."""

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
                      shuffle: bool = True,
                      pad_multiple: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The epoch's (windows, labels) in batches of ``batch_size`` (the
        last may be shorter, or padded to ``pad_multiple`` with copies of its
        last pair), permuted by ``rng`` when ``shuffle``."""
        from sleepgen_torch.parallel.mesh import pad_to_multiple

        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        for i in range(0, len(idx), batch_size):
            sel = idx[i:i + batch_size]
            yield (pad_to_multiple(self.windows[sel], pad_multiple),
                   pad_to_multiple(self.labels[sel], pad_multiple))
