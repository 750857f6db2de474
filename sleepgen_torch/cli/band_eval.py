"""CLI: MS-SSIM and FID per EEG band (delta 0.5-4 Hz, theta 4.1-8, alpha
8.1-12, and the whole band), the reference's testing suite in one CLI
(``src/testing/MSSIM_test.py:118-168``, ``MSSIM_reconstruction.py``,
``FID_test.py:84-230`` and their kin). ``--mode`` picks the pairs:

  * ``test_pairs``: each test window against the next (the diversity floor);
  * ``sample_pairs``: each sample against the next;
  * ``sample_vs_test``: samples against test windows;
  * ``reconstruction``: test windows against the AEKL's reconstruction
    (``--best_model_path``, a port AEKL run dir: ``config.yaml`` and
    ``params.npz``), all ``--max_windows`` of them in one fp32 call.

Both sides are band-passed (``eval/bands.filter_band``) on ``--device``
(default ``cuda``); MS-SSIM uses the first side's range over the whole set
as its data range; FID runs on USleep's bottleneck features, with the
weights of ``--usleep_torch_params`` (a torch state dict in braindecode's
names, the reference's pretrained ``params.pt``) or seeded random ones
from ``--seed``. Writes ``band_eval_<mode>_<metric>_<dataset>.json``. The
JAX CLI's orbax ``--usleep_checkpoint``, multi-host start-up and
compilation cache have no counterpart here.
"""
from __future__ import annotations

import argparse
import json
from glob import glob
from pathlib import Path

import numpy as np
import torch

from sleepgen_torch.cli.compute_fid import load_usleep
from sleepgen_torch.cli.compute_mmds import load_aekl
from sleepgen_torch.config import Config
from sleepgen_torch.data.dataset import load_split
from sleepgen_torch.data.transforms import BORDER_PAD, center_crop_valid, to_bcl
from sleepgen_torch.eval.bands import EEG_BANDS, filter_band
from sleepgen_torch.eval.fid import compute_fid
from sleepgen_torch.eval.msssim import ms_ssim_1d
from sleepgen_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", type=str, required=True,
                   choices=["test_pairs", "sample_pairs", "sample_vs_test", "reconstruction"])
    p.add_argument("--metric", type=str, default="ms_ssim", choices=["ms_ssim", "fid", "both"])
    p.add_argument("--path_test_ids", type=str, default=None)
    p.add_argument("--path_pre_processed", type=str, default=None)
    p.add_argument("--sample_dir", type=str, default=None)
    p.add_argument("--best_model_path", type=str, default=None,
                   help="AEKL port run dir (reconstruction mode)")
    p.add_argument("--usleep_torch_params", type=str, default=None,
                   help="torch .pt state dict (the reference's pretrained USleep)")
    p.add_argument("--dataset", type=str, default="edfx")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--kernel_size", type=int, default=7)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--max_windows", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def _test_windows(args) -> np.ndarray:
    """One window per test recording, (N, 3072, 1), the crops from --seed."""
    ds = load_split(args.path_test_ids, args.path_pre_processed, args.dataset)
    return ds.epoch_windows(np.random.default_rng(args.seed))[:args.max_windows]


def _samples(args) -> np.ndarray:
    """The first --max_windows ``sample_*.npy`` of --sample_dir, (N, 1, L)."""
    files = sorted(glob(f"{args.sample_dir}/sample_*.npy"))[:args.max_windows]
    return np.concatenate([np.load(f) for f in files], axis=0)


def pairs(args, device: torch.device):
    """The mode's two (N, 1, 3000) sides as fp32 tensors on ``device``."""
    def test():
        return to_bcl(center_crop_valid(_test_windows(args)))

    if args.mode == "test_pairs":
        w = test()
        a, b = w[:-1], w[1:]
    elif args.mode == "sample_pairs":
        s = _samples(args)
        a, b = s[:-1], s[1:]
    elif args.mode == "sample_vs_test":
        w, s = test(), _samples(args)
        k = min(len(w), len(s))
        a, b = s[:k], w[:k]
    else:
        cfg = Config.from_yaml(Path(args.best_model_path) / "config.yaml")
        x = torch.as_tensor(to_bcl(_test_windows(args)), device=device)
        with torch.inference_mode():
            recon = load_aekl(args.best_model_path, cfg, device).reconstruct(x).float()
        crop = slice(BORDER_PAD, -BORDER_PAD)
        return x[..., crop], recon[..., crop]
    return (torch.as_tensor(np.asarray(a, np.float32), device=device),
            torch.as_tensor(np.asarray(b, np.float32), device=device))


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sleepgen_torch.utils.profiling import maybe_initialize_multihost

    maybe_initialize_multihost(args.device)
    device = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    a, b = pairs(args, device)

    results = {}
    with torch.inference_mode():
        for band in ("all", *EEG_BANDS):
            fa, fb = (a, b) if band == "all" else (filter_band(a, band), filter_band(b, band))
            entry = {}
            if args.metric in ("ms_ssim", "both"):
                # band-passed signals leave [0, 1]: the data range is the first side's
                dr = max(float(fa.max() - fa.min()), 1e-6)
                ms = ms_ssim_1d(fa, fb, kernel_size=args.kernel_size, data_range=dr).cpu().numpy()
                entry["ms_ssim_mean"] = float(ms.mean())
                entry["ms_ssim_std"] = float(ms.std())
            if args.metric in ("fid", "both"):
                entry["fid"] = compute_fid(load_usleep(args.usleep_torch_params, args.seed),
                                           fb.cpu().numpy(), fa.cpu().numpy(), device=device)
            results[band] = entry
            print(band, entry)

    out = out_dir / f"band_eval_{args.mode}_{args.metric}_{args.dataset}.json"
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
