"""CLI: AE-only samples: the training windows reconstructed through the
stage-1 AutoencoderKL, saved as artifacts (the reference's
``src/testing/sample_trials_autoencoder.py:63-118``).

``--stage1_path`` is a port AEKL run dir (``config.yaml``, ``params.npz``,
such as a port trainer's ``best_model/``). One window of each recording
of ``--path_train_ids`` (crops drawn from the config's seed) goes through
``reconstruct`` (the posterior mean) in fp32 on ``--device`` (default
``cuda``), ``--batch_size`` windows at a time; each batch is written as
``samples/<channels joined by '-'>/synthetic_trial_eeg_<i>.npy`` in (B, 1,
L), and the first batch's original-vs-reconstruction figure beside them
unless ``--no_figures``. The JAX CLI's multi-host start-up and
compilation cache have no counterpart here.
"""
from __future__ import annotations

import argparse
import ast
from pathlib import Path

import numpy as np
import torch

from sleepgen_torch.cli.compute_mmds import load_aekl
from sleepgen_torch.config import Config
from sleepgen_torch.data.dataset import load_split
from sleepgen_torch.data.transforms import to_bcl
from sleepgen_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--stage1_path", type=str, required=True,
                   help="AEKL port run dir (config.yaml + params.npz)")
    p.add_argument("--path_train_ids", type=str, required=True)
    p.add_argument("--path_pre_processed", type=str, required=True)
    p.add_argument("--dataset", type=str, default=None,
                   help="defaults to the run config's dataset")
    p.add_argument("--num_channels", type=str, default=None,
                   help="override AE channels, e.g. '[32,32,64]'")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--no_figures", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sleepgen_torch.utils.profiling import maybe_initialize_multihost

    maybe_initialize_multihost(args.device)
    device = resolve_device(args.device)
    cfg = Config.from_yaml(Path(args.stage1_path) / "config.yaml")
    if args.num_channels is not None:
        cfg.aekl.num_channels = list(ast.literal_eval(args.num_channels))
    ds = load_split(args.path_train_ids, args.path_pre_processed, args.dataset or cfg.dataset)
    windows = ds.epoch_windows(np.random.default_rng(cfg.train.seed))  # (N, 3072, 1)
    ae = load_aekl(args.stage1_path, cfg, device)

    out = Path(args.output_dir) / "samples" / "-".join(str(c) for c in cfg.aekl.num_channels)
    out.mkdir(parents=True, exist_ok=True)
    n_batches = 0
    for i, start in enumerate(range(0, len(windows), args.batch_size)):
        x = to_bcl(windows[start:start + args.batch_size])
        with torch.inference_mode():
            r = ae.reconstruct(torch.as_tensor(x, device=device)).float().cpu().numpy()
        np.save(out / f"synthetic_trial_eeg_{i}.npy", r)
        if i == 0 and not args.no_figures:
            from sleepgen_torch.eval.reports import save_reconstruction_figure

            save_reconstruction_figure(out, 0, x, r)
        n_batches = i + 1
    print(f"wrote {n_batches} reconstruction batches to {out}")
    return out


if __name__ == "__main__":
    main()
