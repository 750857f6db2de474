"""1-D PatchGAN discriminator for the AEKL's adversarial loss, in (B, C, L).

Counterpart of ``sleepgen/nn/discriminator.py::PatchDiscriminator``
(MONAI-generative's ``PatchDiscriminator(spatial_dims=1, num_layers_d=3,
num_channels=64, kernel_size=3, norm="BATCH")``):

  initial: conv k3 s2 (bias) -> LeakyReLU(0.2)                1 -> 64
  layer l: conv k3 s2, s1 for the last (no bias) -> BN -> LReLU  64 -> ... -> 512
  final:   conv k3 s1 (bias), the logits map                  512 -> 1

``forward`` returns every block's output, the logits last. Parameters
carry the JAX modules' names (``initial_conv``, ``layer_{l}_conv``,
``layer_{l}_bn``, ``final_conv``); ``utils/weights.py`` maps a flax tree
onto them.

Two of flax's semantics are kept:

* Convolutions pad as flax's ``"SAME"``: for kernel 3 and stride 2 on an
  even length that is (0, 1), not torch's (1, 1).
* BatchNorm is flax's (``layers.BatchNorm``): in fp32 with the batch's
  statistics, as flax's in training (the only mode the trainer runs); its
  running mean and *biased* variance move only when the caller asks
  (``update_stats``), at flax's momentum 0.9.

``DiscriminatorV1`` is the first-generation PatchGAN
(``sleepgen/nn/discriminator.py::DiscriminatorV1``, reference
``src/models/discriminator.py``): kernel 4 with explicit padding (1, 1),
so its two stride-1 convolutions each shorten the sequence by one; no
LeakyReLU on the logits. Its modules carry the flax module's automatic
names in lower case (``conv_0`` ... ``conv_{n_layers + 1}``, ``bn_0`` ...).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.nn.layers import BatchNorm


def same_padding(length: int, kernel: int, stride: int) -> tuple:
    """(left, right) padding of flax's "SAME": ceil(L / stride) outputs,
    the odd element of the padding on the right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class SameConv1d(nn.Conv1d):
    """Conv1d on (B, C, L) with flax's "SAME" padding for any stride."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride=stride, padding=0,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = same_padding(x.shape[-1], self.kernel_size[0], self.stride[0])
        return super().forward(F.pad(x, pad))


class PatchDiscriminator(nn.Module):
    def __init__(self, num_layers_d: int = 3, num_channels: int = 64, in_channels: int = 1,
                 out_channels: int = 1, kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.num_layers_d = num_layers_d
        self.initial_conv = SameConv1d(in_channels, num_channels, k, stride=2)
        ch = num_channels
        for l in range(num_layers_d):
            stride = 1 if l == num_layers_d - 1 else 2
            self.add_module(f"layer_{l}_conv", SameConv1d(ch, 2 * ch, k, stride, bias=False))
            self.add_module(f"layer_{l}_bn", BatchNorm(2 * ch))
            ch *= 2
        self.final_conv = SameConv1d(ch, out_channels, k)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> List[torch.Tensor]:
        """Every block's output on x (B, C, L), the logits last. BatchNorm
        uses the batch's statistics and moves its running ones only when
        ``update_stats``."""
        h = F.leaky_relu(self.initial_conv(x), 0.2)
        outs = [h]
        for l in range(self.num_layers_d):
            h = getattr(self, f"layer_{l}_conv")(h)
            h = getattr(self, f"layer_{l}_bn")(h, update_stats)
            h = F.leaky_relu(h, 0.2)
            outs.append(h)
        outs.append(self.final_conv(h))
        return outs


class DiscriminatorV1(nn.Module):
    """conv k4 s2 (bias) -> LeakyReLU(0.2); ``n_layers - 1`` x [conv k4 s2
    (no bias) -> BN -> LeakyReLU]; conv k4 s1 (no bias) -> BN -> LeakyReLU;
    conv k4 s1 (bias), the logits map. Channels ndf x min(2**n, 8)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 1):
        super().__init__()
        self.n_layers = n_layers
        self.conv_0 = nn.Conv1d(in_channels, ndf, 4, stride=2, padding=1)
        ch = ndf
        for n in range(1, n_layers + 1):
            out = ndf * min(2**n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv_{n}", nn.Conv1d(ch, out, 4, stride=stride, padding=1,
                                                   bias=False))
            self.add_module(f"bn_{n - 1}", BatchNorm(out))
            ch = out
        self.add_module(f"conv_{n_layers + 1}", nn.Conv1d(ch, 1, 4, stride=1, padding=1))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        """Logits (B, 1, L') of x (B, C, L). BatchNorm uses the batch's
        statistics and moves its running ones only when ``update_stats``."""
        h = F.leaky_relu(self.conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"bn_{n - 1}")(getattr(self, f"conv_{n}")(h), update_stats)
            h = F.leaky_relu(h, 0.2)
        return getattr(self, f"conv_{self.n_layers + 1}")(h)
