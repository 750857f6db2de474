"""CLI: MS-SSIM evaluation (the reference's ``compute_mmds.py``):
``reconstruction`` scores the AEKL's deterministic reconstruction of one
window of each test recording; ``test_pairs`` (``compute_mmds_train_test.py``)
scores each test window against the next, the diversity floor. Writes the
JAX package's TSV files: ``ms_ssim_reconstruction_<dataset>_<spe>_<lc>.tsv``
(columns filename, ms_ssim) or ``ms_ssim_test_pairs_<dataset>.tsv`` (pair,
ms_ssim).

``--best_model_path`` is a port AEKL run dir (``config.yaml`` +
``params.npz``, such as a port trainer's ``best_model/``). The AEKL runs
in fp32, as the JAX CLI's does, whatever the run dir's dtype.
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.data.dataset import load_split
from sleepgen_torch.data.transforms import BORDER_PAD, center_crop_valid, to_bcl
from sleepgen_torch.eval.msssim import ms_ssim_1d
from sleepgen_torch.sample.sample_ldm import build_aekl
from sleepgen_torch.utils.device import resolve_device
from sleepgen_torch.utils.weights import aekl_state_from_jax, load_numpy_state, load_params_npz


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--best_model_path", type=str, required=True, help="AEKL run dir")
    p.add_argument("--path_test_ids", type=str, required=True)
    p.add_argument("--path_pre_processed", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--dataset", type=str, default="edfx")
    p.add_argument("--spe", type=str, default="no-spectral")
    p.add_argument("--latent_channels", type=int, default=None)
    p.add_argument("--mode", type=str, default="reconstruction",
                   choices=["reconstruction", "test_pairs"])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def load_aekl(run: str | Path, cfg: Config, device: torch.device) -> torch.nn.Module:
    """The AEKL of a port run dir (``params.npz``) at ``cfg``'s widths, in
    fp32 and eval mode on ``device``."""
    with torch.device(device):
        ae = load_numpy_state(build_aekl(cfg),
                              aekl_state_from_jax(load_params_npz(Path(run) / "params.npz")))
    return ae.eval()


def reconstruction_scores(ae, windows: np.ndarray, batch_size: int,
                          device: torch.device) -> np.ndarray:
    """MS-SSIM (gaussian, kernel 7) of each (3072, 1) window against the
    AEKL's reconstruction through the posterior mean, both cropped of the
    border pad; one batch of ``batch_size`` windows at a time on
    ``device``, where ``ae`` lives."""
    scores = []
    with torch.inference_mode():
        for i in range(0, len(windows), batch_size):
            x = torch.as_tensor(to_bcl(windows[i:i + batch_size]), device=device)
            r = ae.reconstruct(x).float()
            crop = slice(BORDER_PAD, -BORDER_PAD)
            scores.append(ms_ssim_1d(x[..., crop], r[..., crop], kernel_size=7).cpu().numpy())
    return np.concatenate(scores)


def write_tsv(path: Path, columns, rows) -> None:
    with open(path, "w", newline="") as fh:
        out = csv.writer(fh, delimiter="\t", lineterminator="\n")
        out.writerow(columns)
        out.writerows(rows)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sleepgen_torch.utils.profiling import maybe_initialize_multihost

    maybe_initialize_multihost(args.device)
    device = resolve_device(args.device)
    run = Path(args.best_model_path)
    cfg = Config.from_yaml(run / "config.yaml")
    if args.latent_channels is not None:
        cfg.aekl.latent_channels = args.latent_channels

    ds = load_split(args.path_test_ids, args.path_pre_processed, args.dataset)
    windows = ds.epoch_windows(np.random.default_rng(cfg.train.seed))  # (N, 3072, 1)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.mode == "reconstruction":
        scores = reconstruction_scores(load_aekl(run, cfg, device), windows, args.batch_size,
                                       device)
        lc = cfg.aekl.latent_channels
        out = out_dir / f"ms_ssim_reconstruction_{args.dataset}_{args.spe}_{lc}.tsv"
        write_tsv(out, ("filename", "ms_ssim"), zip(ds.names, scores))
    else:
        x = torch.as_tensor(to_bcl(center_crop_valid(windows)), device=device)
        with torch.inference_mode():
            scores = ms_ssim_1d(x[:-1], x[1:], kernel_size=7).cpu().numpy()
        out = out_dir / f"ms_ssim_test_pairs_{args.dataset}.tsv"
        write_tsv(out, ("pair", "ms_ssim"), enumerate(scores))

    print(f"Mean MS-SSIM: {scores.mean():.6f} -> {out}")
    return float(scores.mean())


if __name__ == "__main__":
    main()
