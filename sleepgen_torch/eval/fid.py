"""Fréchet distance over USleep bottleneck features (the paper's FID).

Counterpart of ``sleepgen/eval/fid.py`` (MONAI-generative's ``FIDMetric``
on the pretrained USleep's bottleneck, the EEG channel duplicated to two):
FID = |mu_a - mu_b|^2 + tr(C_a + C_b - 2 (C_a C_b)^{1/2}), in float64 numpy
on the host, with the matrix square root from symmetric
eigendecompositions. The features come from the port's ``USleep`` on a
device, in batches, in fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from sleepgen_torch.nn.usleep import USleep
from sleepgen_torch.utils.device import resolve_device


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Square root of a (nearly) PSD matrix, negative eigenvalues clipped."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Fréchet distance of two (N, D) feature sets."""
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)
    c_a, c_b = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    diff = a.mean(0) - b.mean(0)
    # tr((Ca Cb)^{1/2}) = tr((Ca^{1/2} Cb Ca^{1/2})^{1/2}), the PSD-stable form
    sa = _sqrtm_psd(c_a)
    covmean = _sqrtm_psd(sa @ c_b @ sa)
    return float(diff @ diff + np.trace(c_a) + np.trace(c_b) - 2.0 * np.trace(covmean))


def usleep_fid_features(usleep: USleep, signals_bcl: np.ndarray, batch_size: int = 256,
                        device: torch.device | str = "cuda") -> np.ndarray:
    """Bottleneck features of (N, 1, L) EEG windows -> (N, D) float32: each
    batch goes to ``device`` (where ``usleep`` is moved, in eval mode),
    its channel duplicated to two, through USleep's encoder; the
    length-1 bottleneck is squeezed (D = 302 at depth 12, L 3000)."""
    dev = resolve_device(device)
    usleep.to(dev).eval()
    outs = []
    with torch.inference_mode():
        for i in range(0, len(signals_bcl), batch_size):
            x = torch.as_tensor(np.asarray(signals_bcl[i:i + batch_size], np.float32),
                                device=dev)
            bottom, _ = usleep.encode(torch.cat([x, x], dim=1))
            outs.append(bottom[:, :, 0].cpu().numpy())
    return np.concatenate(outs, axis=0)


def compute_fid(usleep: USleep, real_bcl: np.ndarray, synth_bcl: np.ndarray,
                batch_size: int = 256, device: torch.device | str = "cuda") -> float:
    """FID of synthetic against real (N, 1, L) windows on USleep's features."""
    real = usleep_fid_features(usleep, real_bcl, batch_size, device)
    synth = usleep_fid_features(usleep, synth_bcl, batch_size, device)
    return frechet_distance(real, synth)
