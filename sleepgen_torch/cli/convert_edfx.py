"""CLI: Sleep-EDFx ingest (the reference's ``src/preprocessing/convert_edfx.py``):
each ``*PSG.edf`` with its ``*Hypnogram*.edf`` becomes cropped (+-30 min
around the scored sleep), 18 Hz low-passed, per-channel (1, T) ``.npy``
files and ``<rec>-annotation.npy``. MNE-free, pure numpy on the host
(``data/edf.py``, ``data/ingest.py``); the PSG/hypnogram pairs must be on
disk already. The JAX CLI's multi-host start-up and compilation cache have
no counterpart here.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from sleepgen_torch.data.ingest import convert_edfx_recording


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", type=str, required=True,
                   help="dir of *-PSG.edf and *-Hypnogram.edf files")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--h_freq", type=float, default=18.0)
    p.add_argument("--crop_wake_mins", type=float, default=30.0)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sleepgen_torch.utils.profiling import maybe_initialize_multihost

    maybe_initialize_multihost(device="cpu")
    data_dir = Path(args.data_dir)
    psgs = sorted(data_dir.glob("*PSG.edf")) or sorted(data_dir.glob("*.edf"))
    for psg in psgs:
        stem = psg.stem.replace("-PSG", "")
        hyps = list(data_dir.glob(f"{stem[:7]}*Hypnogram*.edf"))
        written = convert_edfx_recording(psg, hyps[0] if hyps else None, args.out_dir,
                                         args.h_freq, args.crop_wake_mins)
        print(f"{psg.name}: wrote {sorted(written)}")


if __name__ == "__main__":
    main()
