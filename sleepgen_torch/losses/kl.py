"""KL divergence of the VAE posterior against N(0, I).

Counterpart of ``sleepgen/losses/kl.py``: the reference sums
``0.5 * (mu^2 + sigma^2 - log sigma^2 - 1)`` over every axis but the
batch, (C, L) here, and takes the mean over the batch. It is not a mean
over every element.
"""
from __future__ import annotations

import torch


def kl_gaussian(z_mu: torch.Tensor, z_sigma: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the summed KL, in fp32. Inputs are (B, ...)."""
    z_mu = z_mu.float()
    var = z_sigma.float().square()
    per_sample = 0.5 * (z_mu.square() + var - torch.log(var) - 1.0).sum(
        dim=tuple(range(1, z_mu.dim())))
    return per_sample.mean()
