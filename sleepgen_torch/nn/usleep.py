"""USleep (Perslev et al. 2021), the sleep-staging U-Net whose bottleneck is
the FID feature space, in torch's (B, C, L) layout.

Counterpart of ``sleepgen/nn/usleep.py`` (the reference's vendored
braindecode model): a depth-12 encoder of [conv k7 SAME -> ELU ->
BatchNorm -> (zero pad 1 each side if the length is odd) -> max-pool 2],
a bottom block whose output is the FID feature space, a decoder of
[upsample 2 -> conv k2 padded (0, 1) -> ELU -> BatchNorm -> crop and
concatenate the skip -> conv k7 -> ELU -> BatchNorm], and a head of a 1x1
conv, tanh, an average pool over the window and two more 1x1 convs.

Submodules carry braindecode's ``nn.Sequential`` names
(``encoder.{i}.block_prepool.{0,2}``, ``bottom.{0,2}``,
``decoder.{i}.block_preskip.{1,3}``, ``decoder.{i}.block_postskip.{0,2}``,
``clf.{0,3,5}``), so the reference's pretrained state dict loads with
``strict=True``. BatchNorm is flax's (``layers.BatchNorm``, with torch's
``num_batches_tracked``); the module is an evaluator, used in eval mode
(running statistics, eps 1e-5), in fp32.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.data.transforms import SFREQ
from sleepgen_torch.nn.layers import BatchNorm

IN_CHANS = 2
N_CLASSES = 5

def usleep_channels(in_chans: int, depth: int, n_time_filters: int = 5,
                    complexity_factor: float = 1.67) -> List[int]:
    """The reference's integer-truncation recurrence of channel widths:
    ch_{i+1} = int(nf_i sqrt(complexity_factor)), nf_{i+1} = int(nf_i sqrt(2))."""
    channels = [in_chans]
    nf = n_time_filters
    for _ in range(depth + 1):
        channels.append(int(nf * math.sqrt(complexity_factor)))
        nf = int(nf * math.sqrt(2))
    return channels


def _conv_elu_bn(in_ch: int, out_ch: int, kernel: int, padding="same") -> List[nn.Module]:
    return [nn.Conv1d(in_ch, out_ch, kernel, padding=padding), nn.ELU(),
            BatchNorm(out_ch, count_batches=True)]


class EncoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.block_prepool = nn.Sequential(*_conv_elu_bn(in_ch, out_ch, kernel))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (the pooled output, the skip before pooling)."""
        residual = self.block_prepool(x)
        h = F.pad(residual, (1, 1)) if residual.shape[-1] % 2 else residual
        return F.max_pool1d(h, 2), residual


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        upsample = nn.Sequential(nn.Upsample(scale_factor=2), nn.ConstantPad1d((0, 1), 0.0))
        self.block_preskip = nn.Sequential(upsample, *_conv_elu_bn(in_ch, out_ch, 2, padding=0))
        self.block_postskip = nn.Sequential(*_conv_elu_bn(2 * out_ch, out_ch, kernel))

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        h = self.block_preskip(x)
        m = min(h.shape[-1], residual.shape[-1])
        return self.block_postskip(torch.cat([h[..., :m], residual[..., :m]], dim=1))


class USleep(nn.Module):
    """The reference's configuration: 2 input channels (the EEG channel
    twice, for FID), 100 Hz, kernel 7 (9/128 s), 5 classes; ``depth`` and
    the classifier's window ``input_size_s`` are the only choices."""

    def __init__(self, depth: int = 12, input_size_s: float = 30.0):
        super().__init__()
        k = int(round(9 / 128 * SFREQ))  # 7
        self.input_size = int(math.ceil(input_size_s * SFREQ))
        chans = usleep_channels(IN_CHANS, depth)
        self.encoder = nn.ModuleList(EncoderBlock(chans[i], chans[i + 1], k)
                                     for i in range(depth))
        self.bottom = nn.Sequential(*_conv_elu_bn(chans[-2], chans[-1], k))
        rev = chans[::-1]
        self.decoder = nn.ModuleList(DecoderBlock(rev[i], rev[i + 1], k)
                                     for i in range(depth))
        self.clf = nn.Sequential(nn.Conv1d(chans[1], chans[1], 1), nn.Tanh(),
                                 nn.AvgPool1d(self.input_size),
                                 nn.Conv1d(chans[1], N_CLASSES, 1), nn.ELU(),
                                 nn.Conv1d(N_CLASSES, N_CLASSES, 1))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, 2, L) -> (the bottleneck features (B, chans[-1],
        L_bottom), the encoder's skips). The FID features need only this
        half of the network."""
        residuals = []
        h = x
        for block in self.encoder:
            h, res = block(h)
            residuals.append(res)
        return self.bottom(h), residuals

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, 2, L) -> (y, decoded, bottom): class scores (B, 5), or
        (B, 5, L // input_size) for a longer input;
        the decoder's output (B, chans[1], L); the bottleneck features
        (B, chans[-1], L_bottom)."""
        bottom, residuals = self.encode(x)
        h = bottom
        for block, res in zip(self.decoder, reversed(residuals)):
            h = block(h, res)
        y = self.clf(h)
        return (y[..., 0] if y.shape[-1] == 1 else y), h, bottom
