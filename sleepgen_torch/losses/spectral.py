"""Spectral (Jukebox) loss: the L2 distance of FFT amplitudes.

Counterpart of ``sleepgen/losses/spectral.py`` (MONAI-generative's
``JukeboxLoss(spatial_dims=1)``): amplitude = |FFT(x)| with "ortho"
normalisation along the time axis, loss = the squared difference of the
two amplitudes reduced by ``"sum"`` (the trainer's, so it grows with the
batch) or ``"mean"``. The FFT and the reduction run in fp32 whatever the
compute dtype, as the reference found this loss numerically fragile.
The time axis is -1 in the port's (B, C, L) layout (-2 in the JAX
package's (B, L, C)).
"""
from __future__ import annotations

import torch


def fft_amplitude(x: torch.Tensor) -> torch.Tensor:
    """|FFT(x)| along the time axis with ortho normalisation, in fp32."""
    xf = torch.fft.fft(x.float(), dim=-1, norm="ortho")
    return torch.sqrt(xf.real.square() + xf.imag.square())


def jukebox_loss(recon: torch.Tensor, target: torch.Tensor,
                 reduction: str = "sum") -> torch.Tensor:
    """Spectral L2 between the FFT amplitudes of ``recon`` and ``target``."""
    sq = (fft_amplitude(target) - fft_amplitude(recon)).square()
    if reduction == "sum":
        return sq.sum()
    if reduction == "mean":
        return sq.mean()
    raise ValueError(reduction)
