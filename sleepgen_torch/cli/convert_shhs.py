"""CLI: SHHS ingest (the reference's ``src/preprocessing/convert_shhs.py``):
an EDF and its profusion XML labels per id become stage-mapped labels (N4
-> N3, REM -> 4) and the first two EEG channels, 18 Hz low-passed,
resampled to 100 Hz and cropped to +-30 min around the non-wake epochs,
saved as ``shhs1-<id>-C4-A1.npy``, ``-C3-A2.npy`` and ``-stages.npy``.
Pure numpy on the host; the ids CSV is read with ``csv``. The JAX CLI's
multi-host start-up and compilation cache have no counterpart here.
"""
from __future__ import annotations

import argparse
import csv
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from sleepgen_torch.data.edf import read_edf
from sleepgen_torch.data.ingest import lowpass_fir, map_shhs_stages, resample_fft


def parse_profusion_stages(xml_path: str | Path) -> np.ndarray:
    """The SleepStages of a profusion XML (convert_shhs.py:86-99)."""
    root = ET.parse(xml_path).getroot()
    stages = root.find("SleepStages")
    if stages is None:  # the reference indexes r[4]
        stages = list(root)[4]
    return np.asarray([int(s.text) for s in stages], np.int64)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--edf_dir", type=str, required=True)
    p.add_argument("--ann_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--ids_csv", type=str, required=True, help="CSV with an nsrrid column")
    p.add_argument("--target_sfreq", type=float, default=100.0)
    p.add_argument("--h_freq", type=float, default=18.0)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sleepgen_torch.utils.profiling import maybe_initialize_multihost

    maybe_initialize_multihost(device="cpu")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(args.ids_csv, newline="") as fh:
        ids = [row["nsrrid"] for row in csv.DictReader(fh)]
    if all(i.strip().lstrip("-").isdigit() for i in ids):  # an integer column, as pandas reads it
        ids = [str(int(i)) for i in ids]

    for nsrrid in ids:
        edf_path = Path(args.edf_dir) / f"shhs1-{nsrrid}.edf"
        xml_path = Path(args.ann_dir) / f"shhs1-{nsrrid}-profusion.xml"
        if not edf_path.exists() or not xml_path.exists():
            print(f"missing {nsrrid}")
            continue
        labels = parse_profusion_stages(xml_path)
        if labels.max() > 5:
            print(f"faulty labels in {nsrrid}")
            continue
        y = map_shhs_stages(labels)
        # the crop, in 30 s epochs around the non-wake ones (convert_shhs.py:104-113)
        nw = np.flatnonzero(y != 0)
        if len(nw) == 0:
            print(f"no sleep epochs in {nsrrid}, skipping")
            continue
        start_ep = max(nw[0] - 60, 0)  # 30 min = 60 epochs
        end_ep = min(nw[-1] + 60, len(y) - 1)

        edf = read_edf(edf_path)
        eeg_idx = sorted(i for i, label in enumerate(edf.labels) if "EEG" in label)
        for name, i in zip(["C4-A1", "C3-A2"], eeg_idx[:2]):
            sf = edf.sfreq(i)
            x = resample_fft(lowpass_fir(edf.data[i], args.h_freq, sf), sf, args.target_sfreq)
            sf2 = args.target_sfreq
            seg = x[int(start_ep * sf2 * 30): int((end_ep + 1) * sf2 * 30)]
            np.save(out_dir / f"shhs1-{nsrrid}-{name}.npy", seg)
        np.save(out_dir / f"shhs1-{nsrrid}-stages.npy", y[start_ep:end_ep + 1])
        print(f"converted {nsrrid}")


if __name__ == "__main__":
    main()
