"""CLI: FID of synthetic EEG windows against a test split, on USleep
bottleneck features (the reference's ``compute_fid.py``); without
``--sample_dir``, the test-vs-test floor (``compute_fid_train_test.py``):
the first half of the test windows against the second.

USleep's weights: ``--usleep_torch_params``, a torch state dict in
braindecode's names (the reference's pretrained ``params.pt``; a
``module.`` prefix is stripped), loaded with ``strict=True``; else seeded
random weights from ``--seed``
(``lecun_normal_state``: numpy draws of the JAX package's initialisers,
not the same numbers as JAX's own random init, which comes from a
threefry key torch cannot reproduce).
"""
from __future__ import annotations

import argparse
from glob import glob

import numpy as np
import torch

from sleepgen_torch.data.dataset import load_split
from sleepgen_torch.data.transforms import center_crop_valid, to_bcl
from sleepgen_torch.eval.fid import compute_fid, frechet_distance, usleep_fid_features
from sleepgen_torch.nn.usleep import USleep
from sleepgen_torch.utils.device import resolve_device
from sleepgen_torch.utils.weights import lecun_normal_state, load_numpy_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--path_test_ids", type=str, required=True)
    p.add_argument("--path_pre_processed", type=str, required=True)
    p.add_argument("--sample_dir", type=str, default=None,
                   help="dir of sample_*.npy; omit for the test-vs-test floor")
    p.add_argument("--usleep_torch_params", type=str, default=None,
                   help="torch .pt state dict (the reference's pretrained USleep)")
    p.add_argument("--dataset", type=str, default="edfx")
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def load_usleep(torch_params: str | None = None, seed: int = 0) -> USleep:
    """The FID extractor as the reference builds it (2 channels, depth 12,
    5 classes, 30 s at 100 Hz), on the CPU, with the weights above."""
    m = USleep()
    if torch_params:
        sd = torch.load(torch_params, map_location="cpu", weights_only=True)
        m.load_state_dict({k.removeprefix("module."): v for k, v in sd.items()}, strict=True)
    else:
        load_numpy_state(m, lecun_normal_state(m, seed))
    return m.eval()


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sleepgen_torch.utils.profiling import maybe_initialize_multihost

    maybe_initialize_multihost(args.device)
    device = resolve_device(args.device)
    ds = load_split(args.path_test_ids, args.path_pre_processed, args.dataset)
    windows = to_bcl(center_crop_valid(ds.epoch_windows(np.random.default_rng(args.seed))))
    m = load_usleep(args.usleep_torch_params, args.seed)

    if args.sample_dir:
        files = sorted(glob(f"{args.sample_dir}/sample_*.npy"))
        synth = np.concatenate([np.load(f) for f in files], axis=0)
        fid = compute_fid(m, windows, synth, args.batch_size, device)
        print(f"FID (synthetic vs test): {fid:.6f}")
    else:
        feats = usleep_fid_features(m, windows, args.batch_size, device)
        half = len(feats) // 2
        fid = frechet_distance(feats[:half], feats[half:2 * half])
        print(f"FID (test vs test floor): {fid:.6f}")
    return fid


if __name__ == "__main__":
    main()
