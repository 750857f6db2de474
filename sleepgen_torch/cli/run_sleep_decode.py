"""CLI: downstream sleep-stage decoding (the reference's
``src/testing/run_sleep_decode.py`` and its _b / _c variants):

  * variant a: Chambon 2018's features over 3-window sequences
    (``TimeDistributedStager``), labelled by the centre window;
  * variant b: the single-window ``SleepStagerChambon2018`` (dropout 0.5);
  * variant c: single-window ``DeepSleepNet``.

Reads the per-recording ``<rec>-<channel>.npy`` and
``<rec>-annotation.npy`` files that ``convert-edfx`` writes, splits the
recordings 60/20/20 with ``RandomState(42)`` (the test fifth is held
out), trains with ``train_decoder`` on ``--device`` (default ``cuda``) and
writes ``history.json`` and ``confusion_matrix.npy`` under
``--output_dir`` (joined with the config's run dir when ``--config_file``
is given, which also sets the seed). The JAX CLI's multi-host start-up
and compilation cache have no counterpart here.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Tuple

import numpy as np

from sleepgen_torch.config import Config
from sleepgen_torch.data.staging import (center_label, sequence_indices,
                                         standard_scale_windows, windows_from_annotations)
from sleepgen_torch.nn.chambon import SleepStagerChambon2018, TimeDistributedStager
from sleepgen_torch.nn.deepsleepnet import DeepSleepNet
from sleepgen_torch.train.decode import train_decoder
from sleepgen_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", type=str, required=True,
                   help="dir with <rec>-<ch>.npy and <rec>-annotation.npy")
    p.add_argument("--channel", type=str, default="Fpz-Cz")
    p.add_argument("--variant", type=str, default="a", choices=["a", "b", "c"])
    p.add_argument("--n_epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--output_dir", type=str, default="decode_out")
    p.add_argument("--seed", type=int, default=None,
                   help="overrides the config seed (reference default 1996)")
    p.add_argument("--config_file", type=str, default=None,
                   help="sleep_stage{,_b,_c}.yaml: sets seed and the run-dir name")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def load_staged_dataset(data_dir: Path, channel: str) -> Tuple[np.ndarray, ...]:
    """(windows (N, 3000, 1), labels (N,), recording ids (N,)) from the
    ingest outputs: each signal x 1e6 (volts to uV), cut into labelled 30 s
    windows, each window standard-scaled."""
    xs, ys, rids = [], [], []
    for ann_path in sorted(data_dir.glob("*-annotation.npy")):
        stem = ann_path.name.replace("-annotation.npy", "")
        sig_path = data_dir / f"{stem}-{channel}.npy"
        if not sig_path.exists():
            continue
        sig = np.load(sig_path).reshape(-1) * 1e6
        anns = [(float(o), float(d), str(t)) for o, d, t in np.load(ann_path, allow_pickle=True)]
        x, y = windows_from_annotations(sig, 100, anns)
        if len(x) == 0:
            continue
        xs.append(standard_scale_windows(x))
        ys.append(y)
        rids.append(np.full(len(y), len(rids)))
    return np.concatenate(xs), np.concatenate(ys), np.concatenate(rids)


def split_recordings(rids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train, valid, test) recording ids: ceil(20 %) test first from a
    RandomState(42) permutation, then ceil(25 %) of the rest valid."""
    recs = np.unique(rids)
    perm = np.random.RandomState(42).permutation(len(recs))
    n_test = int(np.ceil(len(recs) * 0.2))
    test_r, rest = recs[perm[:n_test]], recs[perm[n_test:]]
    n_val = int(np.ceil(len(rest) * 0.25))
    return rest[n_val:], rest[:n_val], test_r


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sleepgen_torch.utils.profiling import maybe_initialize_multihost

    maybe_initialize_multihost(args.device)
    device = resolve_device(args.device)
    out = Path(args.output_dir)
    seed = args.seed
    if args.config_file:
        cfg = Config.from_yaml(args.config_file)
        if seed is None:
            seed = cfg.train.seed
        out = out / cfg.train.run_dir
    if seed is None:
        seed = 2
    x, y, rids = load_staged_dataset(Path(args.data_dir), args.channel)
    train_r, valid_r, _ = split_recordings(rids)

    def take(rs):
        m = np.isin(rids, rs)
        return x[m], y[m], rids[m]

    xtr, ytr, rtr = take(train_r)
    xva, yva, rva = take(valid_r)
    if args.variant == "a":
        str_, sva = sequence_indices(rtr, 3, 3), sequence_indices(rva, 3, 3)
        train_xy = (xtr[str_], center_label(ytr, str_))
        valid_xy = (xva[sva], center_label(yva, sva))
        model = TimeDistributedStager(n_chans=1, sfreq=100)
    elif args.variant == "b":
        train_xy, valid_xy = (xtr, ytr), (xva, yva)
        model = SleepStagerChambon2018(n_chans=1, sfreq=100, dropout=0.5)
    else:
        train_xy, valid_xy = (xtr, ytr), (xva, yva)
        model = DeepSleepNet(n_outputs=5, sfreq=100)

    res = train_decoder(model, train_xy, valid_xy, n_epochs=args.n_epochs,
                        batch_size=args.batch_size, seed=seed, device=device)
    out.mkdir(parents=True, exist_ok=True)
    (out / "history.json").write_text(json.dumps(res.history, indent=1))
    np.save(out / "confusion_matrix.npy", res.confusion)
    print(f"best valid balanced accuracy: {res.best_valid_bal_acc:.4f}")
    print("confusion matrix (rows=true Wake/N1/N2/N3/REM):")
    print(res.confusion)
    return res


if __name__ == "__main__":
    main()
