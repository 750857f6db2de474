"""1-D SSIM and MS-SSIM on (B, C, L) tensors.

Counterpart of ``sleepgen/eval/msssim.py``, the reference's 1-D MONAI
metric: a gaussian kernel (size 7, sigma 1.5) for reconstruction quality
and pair diversity, or a uniform kernel (size 16) for the band suite;
data range 1.0 and MONAI's MS-SSIM weights. Every window statistic is a
valid depthwise convolution (``F.conv1d`` with ``groups=C``) in fp32 on
the inputs' device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def gaussian_kernel_1d(kernel_size: int = 7, sigma: float = 1.5) -> np.ndarray:
    """MONAI's gaussian_1d: exp(-t^2 / (2 sigma^2)) over a centred integer
    grid, normalised to sum 1."""
    dist = np.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0)
    g = np.exp(-(dist**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def uniform_kernel_1d(kernel_size: int = 16) -> np.ndarray:
    """The box kernel of MONAI's kernel_type='uniform'."""
    return np.full((kernel_size,), 1.0 / kernel_size, np.float32)


def _make_kernel(kernel_size: int, sigma: float, kernel_type: str) -> np.ndarray:
    if kernel_type == "gaussian":
        return gaussian_kernel_1d(kernel_size, sigma)
    if kernel_type == "uniform":
        return uniform_kernel_1d(kernel_size)
    raise ValueError(f"unknown kernel_type '{kernel_type}'")


def _depthwise_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid convolution of each channel of (B, C, L) with the (K,) kernel."""
    c = x.shape[1]
    return F.conv1d(x, kernel.view(1, 1, -1).expand(c, 1, -1), groups=c)


def ssim_and_cs(x: torch.Tensor, y: torch.Tensor, kernel: torch.Tensor,
                data_range: float = 1.0, k1: float = 0.01,
                k2: float = 0.03) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSIM and contrast-sensitivity maps, each averaged over (C, L) -> (B,)."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    x, y = x.float(), y.float()
    mu_x = _depthwise_conv(x, kernel)
    mu_y = _depthwise_conv(y, kernel)
    var_x = _depthwise_conv(x * x, kernel) - mu_x * mu_x
    var_y = _depthwise_conv(y * y, kernel) - mu_y * mu_y
    cov = _depthwise_conv(x * y, kernel) - mu_x * mu_y
    cs = (2 * cov + c2) / (var_x + var_y + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1)) * cs
    return ssim.mean(dim=(1, 2)), cs.mean(dim=(1, 2))


def ssim_1d(x: torch.Tensor, y: torch.Tensor, kernel_size: int = 7, sigma: float = 1.5,
            data_range: float = 1.0, kernel_type: str = "gaussian") -> torch.Tensor:
    """SSIM of (B, C, L) pairs -> (B,)."""
    kernel = torch.as_tensor(_make_kernel(kernel_size, sigma, kernel_type), device=x.device)
    return ssim_and_cs(x, y, kernel, data_range)[0]


def ms_ssim_1d(x: torch.Tensor, y: torch.Tensor, kernel_size: int = 7, sigma: float = 1.5,
               data_range: float = 1.0, weights: Sequence[float] = MSSSIM_WEIGHTS,
               kernel_type: str = "gaussian") -> torch.Tensor:
    """Multi-scale SSIM of (B, C, L) pairs -> (B,) fp32: each scale but the
    last keeps relu(cs) and average-pools both inputs by 2 (flooring), the
    last keeps relu(ssim); the result is prod(v_i ** w_i)."""
    kernel = torch.as_tensor(_make_kernel(kernel_size, sigma, kernel_type), device=x.device)
    vals = []
    for i in range(len(weights)):
        s, cs = ssim_and_cs(x, y, kernel, data_range)
        if i < len(weights) - 1:
            vals.append(torch.relu(cs))
            x, y = F.avg_pool1d(x.float(), 2), F.avg_pool1d(y.float(), 2)
        else:
            vals.append(torch.relu(s))
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    return torch.prod(torch.stack(vals) ** w[:, None], dim=0)
