"""Pure-numpy EDF/EDF+ reader and writer, the ingest's MNE-free core.

The port's own copy of ``sleepgen/data/edf.py``, which replaces
``mne.io.read_raw_edf`` on the reference's ingest path
(``src/preprocessing/convert_edfx.py:38``, ``convert_shhs.py:77``). EDF is
a fixed-layout binary format: a 256-byte global header, 256 bytes per
signal, then interleaved data records of little-endian int16 samples,
mapped to physical units by each signal's linear calibration. EDF+
annotations (time-stamped annotation lists, TALs) in 'EDF Annotations'
channels carry the Sleep-EDFx hypnograms. ``write_edf`` writes the same
bytes as the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class EdfSignal:
    label: str
    transducer: str
    dimension: str
    physical_min: float
    physical_max: float
    digital_min: int
    digital_max: int
    prefiltering: str
    samples_per_record: int

    @property
    def gain(self) -> float:
        drange = self.digital_max - self.digital_min
        return (self.physical_max - self.physical_min) / drange if drange else 1.0

    @property
    def offset(self) -> float:
        return self.physical_min - self.gain * self.digital_min


@dataclass
class EdfFile:
    header: Dict[str, str]
    n_records: int
    record_duration: float
    signals: List[EdfSignal]
    data: List[np.ndarray]  # physical units, one (T,) array per signal
    annotations: List[Tuple[float, float, str]]  # (onset_s, duration_s, text)

    @property
    def labels(self) -> List[str]:
        return [s.label for s in self.signals]

    def sfreq(self, idx: int) -> float:
        return self.signals[idx].samples_per_record / self.record_duration

    def get(self, label: str) -> np.ndarray:
        return self.data[self.labels.index(label)]


def _field(buf: bytes, start: int, length: int) -> str:
    return buf[start : start + length].decode("ascii", errors="replace").strip()


def _parse_tals(raw: bytes) -> List[Tuple[float, float, str]]:
    """EDF+ Time-stamped Annotation Lists: onset[(\\x15)duration]\\x14text\\x14...\\x00"""
    out = []
    for tal in raw.split(b"\x00"):
        if not tal:
            continue
        parts = tal.split(b"\x14")
        stamp = parts[0]
        if b"\x15" in stamp:
            onset_b, dur_b = stamp.split(b"\x15")
            duration = float(dur_b)
        else:
            onset_b, duration = stamp, 0.0
        try:
            onset = float(onset_b)
        except ValueError:
            continue
        for text in parts[1:]:
            if text:
                out.append((onset, duration, text.decode("utf-8", errors="replace")))
    return out


def read_edf(path: str | Path, include: Optional[List[str]] = None) -> EdfFile:
    """Read an EDF/EDF+ file into physical-unit float64 arrays.

    ``include``: optional channel-label whitelist (annotation channels are
    always parsed, never returned as data).
    """
    with open(path, "rb") as fh:
        buf = fh.read()

    header = {
        "version": _field(buf, 0, 8),
        "patient": _field(buf, 8, 80),
        "recording": _field(buf, 88, 80),
        "startdate": _field(buf, 168, 8),
        "starttime": _field(buf, 176, 8),
    }
    header_bytes = int(_field(buf, 184, 8))
    n_records = int(_field(buf, 236, 8))
    record_duration = float(_field(buf, 244, 8))
    n_signals = int(_field(buf, 252, 4))

    def sig_fields(offset: int, length: int) -> List[str]:
        base = 256 + offset * n_signals
        return [_field(buf, base + i * length, length) for i in range(n_signals)]

    # per-signal header blocks are stored field-major
    labels = sig_fields(0, 16)
    transducers = [
        _field(buf, 256 + 16 * n_signals + i * 80, 80) for i in range(n_signals)]
    base = 256 + (16 + 80) * n_signals
    def block(width):
        nonlocal base
        vals = [_field(buf, base + i * width, width) for i in range(n_signals)]
        base += width * n_signals
        return vals

    dimensions = block(8)
    phys_min = [float(v) for v in block(8)]
    phys_max = [float(v) for v in block(8)]
    dig_min = [int(float(v)) for v in block(8)]
    dig_max = [int(float(v)) for v in block(8)]
    prefilter = block(80)
    spr = [int(v) for v in block(8)]
    base += 32 * n_signals  # reserved

    signals = [
        EdfSignal(labels[i], transducers[i], dimensions[i], phys_min[i],
                  phys_max[i], dig_min[i], dig_max[i], prefilter[i], spr[i])
        for i in range(n_signals)
    ]

    record_len = sum(spr)
    raw = np.frombuffer(buf, dtype="<i2", offset=header_bytes)
    if n_records < 0:  # unknown length: infer
        n_records = len(raw) // record_len
    raw = raw[: n_records * record_len].reshape(n_records, record_len)

    offsets = np.concatenate([[0], np.cumsum(spr)])
    data: List[np.ndarray] = []
    annotations: List[Tuple[float, float, str]] = []
    for i, sig in enumerate(signals):
        chunk = raw[:, offsets[i] : offsets[i + 1]]
        if "EDF Annotations" in sig.label:
            annotations.extend(_parse_tals(chunk.astype("<i2").tobytes()))
            continue
        if include is not None and sig.label not in include:
            continue
        data.append(chunk.reshape(-1).astype(np.float64) * sig.gain + sig.offset)

    kept = [s for s in signals
            if "EDF Annotations" not in s.label
            and (include is None or s.label in include)]
    return EdfFile(header, n_records, record_duration, kept, data, annotations)


# -- writer -------------------------------------------------------------------

def _record_tal(r: int, annotations) -> bytes:
    """One annotation-channel record: the record-keeping TAL, then one TAL
    per annotation — each terminated by \\x00 per the EDF+ spec."""
    tal = f"+{r}\x14\x14\x00".encode()
    for onset, dur, text in annotations:
        tal += f"+{onset}\x15{dur}\x14{text}\x14\x00".encode()
    return tal


def write_edf(path: str | Path, signals, labels, sfreq: float,
              annotations=None, physical_range: float = 250.0) -> None:
    """Minimal EDF+ writer — the inverse of :func:`read_edf` for synthetic
    fixtures (the reference pipeline starts from PhysioNet/NSRR EDFs; this
    environment has no egress, so demos and tests synthesize their own).
    ``signals``: list of 1-D arrays in the signal's physical units (uV
    scale by convention); ``annotations``: (onset_s, duration_s, text)
    TALs, all packed into record 0."""
    path = Path(path)
    n_sig = len(signals) + (1 if annotations else 0)
    record_dur = 1.0
    n_records = int(len(signals[0]) / sfreq)
    # annotation-channel record size: big enough for every TAL (all are
    # packed into record 0) — EDF+ stores 2 bytes per "sample"
    ann_bytes = 64
    if annotations:
        need = len(_record_tal(0, annotations))
        while ann_bytes < need:
            ann_bytes *= 2
    ann_spr = ann_bytes // 2

    def pad(s, n):
        return s[:n].ljust(n).encode("ascii")

    hdr = b"".join([
        pad("0", 8), pad("synthetic patient", 80), pad("synthetic rec", 80),
        pad("01.01.23", 8), pad("00.00.00", 8),
        pad(str(256 * (1 + n_sig)), 8), pad("", 44),
        pad(str(n_records), 8), pad(str(record_dur), 8), pad(str(n_sig), 4),
    ])
    all_labels = list(labels) + (["EDF Annotations"] if annotations else [])
    sprs = [int(sfreq)] * len(signals) + ([ann_spr] if annotations else [])
    pmins = [-physical_range] * len(signals) + ([-1.0] if annotations else [])
    pmaxs = [physical_range] * len(signals) + ([1.0] if annotations else [])
    dmins = [-2048] * len(signals) + ([-32768] if annotations else [])
    dmaxs = [2047] * len(signals) + ([32767] if annotations else [])

    sig_hdr = b"".join(pad(l, 16) for l in all_labels)
    sig_hdr += b"".join(pad("", 80) for _ in range(n_sig))
    sig_hdr += b"".join(pad("uV", 8) for _ in range(n_sig))
    sig_hdr += b"".join(pad(str(v), 8) for v in pmins)
    sig_hdr += b"".join(pad(str(v), 8) for v in pmaxs)
    sig_hdr += b"".join(pad(str(v), 8) for v in dmins)
    sig_hdr += b"".join(pad(str(v), 8) for v in dmaxs)
    sig_hdr += b"".join(pad("", 80) for _ in range(n_sig))
    sig_hdr += b"".join(pad(str(v), 8) for v in sprs)
    sig_hdr += b"".join(pad("", 32) for _ in range(n_sig))

    dig = []
    for s, pmin, pmax, dmin, dmax in zip(signals, pmins, pmaxs, dmins, dmaxs):
        gain = (pmax - pmin) / (dmax - dmin)
        dig.append(np.clip(np.round((np.asarray(s) - pmin) / gain + dmin),
                           dmin, dmax).astype("<i2"))

    records = []
    for r in range(n_records):
        for d in dig:
            records.append(d[r * int(sfreq):(r + 1) * int(sfreq)].tobytes())
        if annotations:
            tal = _record_tal(r, annotations if r == 0 else [])
            tal = tal.ljust(ann_spr * 2, b"\x00")
            assert len(tal) == ann_spr * 2, "annotation record overflow"
            records.append(tal)
    path.write_bytes(hdr + sig_hdr + b"".join(records))
