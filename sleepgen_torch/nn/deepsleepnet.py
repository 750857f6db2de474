"""DeepSleepNet (Supratak et al. 2017), the third downstream decoder, on
(B, C, T).

Counterpart of ``sleepgen/nn/deepsleepnet.py``: two CNN branches over the
raw 30 s window, a small-filter one (kernel sfreq/2, stride sfreq/16,
pools 8 and 4) and a large-filter one (kernel 4 sfreq, stride sfreq/2,
pools 4 and 2), each [conv 64 -> BatchNorm -> ReLU -> max-pool -> dropout
-> 3 x (conv 128 -> BatchNorm -> ReLU) -> max-pool], concatenated, dropout,
then a residual sequence head: two bidirectional LSTM layers of 512 per
direction, each followed by dropout, plus a 1024-wide linear shortcut of
the features, dropout, linear. A single window is a sequence of one.

flax's semantics are kept where torch's defaults differ:

* every convolution and max-pool pads as flax's "SAME" (TF-style, the odd
  element on the right; the pools with -inf), which ``nn.Conv1d`` cannot
  do at stride > 1 nor ``nn.MaxPool1d`` unevenly: 500 -> 63 pads the
  pool (2, 2), 63 -> 16 pads (0, 1), 15 -> 8 pads (0, 1);
* each branch's features flatten in flax's (T', C) order, so the JAX
  weights map onto the shortcut and the LSTMs unchanged;
* flax's ``OptimizedLSTMCell`` has one bias per gate, on the hidden
  kernels: ``bias_hh`` holds it and ``bias_ih`` stays zero (its
  ``requires_grad`` is False, so no optimiser moves it). Gate order
  (i, f, g, o) is torch's. The backward direction is flax's ``reverse=True,
  keep_order=True``;
* two single-layer bidirectional LSTMs with explicit dropout after each
  layer's concatenation and again after the residual add, as the JAX
  module does (``nn.LSTM(num_layers=2, dropout=...)`` would drop only
  between the layers).

Parameter names follow the JAX module's (``branch_small.conv1``,
``branch_small.bn2_0``, ``shortcut``, ``lstm_0``, ``fc``);
``utils/weights.py`` maps a flax tree onto them. Initial weights are the
trainer's (``utils/weights.flax_init_state``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.data.transforms import WINDOW_SIZE
from sleepgen_torch.nn.discriminator import SameConv1d, same_padding
from sleepgen_torch.nn.layers import BatchNorm, dropout

HIDDEN = 512
SHORTCUT = 1024


def same_max_pool(x: torch.Tensor, pool: int) -> torch.Tensor:
    """flax's ``max_pool(x, (pool,), strides=(pool,), padding="SAME")`` on
    (B, C, L): ceil(L / pool) outputs, -inf padding."""
    return F.max_pool1d(F.pad(x, same_padding(x.shape[-1], pool, pool), value=-torch.inf), pool)


def same_length(length: int, stride: int) -> int:
    return -(-length // stride)


class _CNNBranch(nn.Module):
    def __init__(self, kernel: int, stride: int, pool1: int, kernel_small: int, pool2: int):
        super().__init__()
        self.pools = (pool1, pool2)
        self.stride = stride
        self.conv1 = SameConv1d(1, 64, kernel, stride=stride, bias=False)
        self.bn1 = BatchNorm(64)
        for i in range(3):
            self.add_module(f"conv2_{i}", SameConv1d(64 if i == 0 else 128, 128, kernel_small,
                                                     bias=False))
            self.add_module(f"bn2_{i}", BatchNorm(128))

    def out_length(self, n_times: int) -> int:
        length = same_length(n_times, self.stride)
        for pool in self.pools:
            length = same_length(length, pool)
        return length

    def forward(self, x: torch.Tensor, update_stats: bool, p: float,
                generator: torch.Generator | None) -> torch.Tensor:
        h = same_max_pool(F.relu(self.bn1(self.conv1(x), update_stats)), self.pools[0])
        h = dropout(h, p, self.training, generator)
        for i in range(3):
            h = F.relu(getattr(self, f"bn2_{i}")(getattr(self, f"conv2_{i}")(h), update_stats))
        return same_max_pool(h, self.pools[1])


class DeepSleepNet(nn.Module):
    """x (B, 1, 3000) single windows or (B, S, 1, 3000) sequences -> logits
    (B, n_outputs) or (B, S, n_outputs). Every dropout's rate is
    ``p_dropout``, the JAX module's 0.5."""

    def __init__(self, n_outputs: int = 5, sfreq: float = 100.0):
        super().__init__()
        sf = int(sfreq)
        self.branch_small = _CNNBranch(sf // 2, sf // 16, 8, 8, 4)
        self.branch_large = _CNNBranch(sf * 4, sf // 2, 4, 6, 2)
        self.p_dropout = 0.5
        n_feats = 128 * sum(b.out_length(WINDOW_SIZE)
                            for b in (self.branch_small, self.branch_large))
        self.shortcut = nn.Linear(n_feats, SHORTCUT)
        self.lstm_0 = nn.LSTM(n_feats, HIDDEN, batch_first=True, bidirectional=True)
        self.lstm_1 = nn.LSTM(2 * HIDDEN, HIDDEN, batch_first=True, bidirectional=True)
        for lstm in (self.lstm_0, self.lstm_1):
            for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
                bias = getattr(lstm, name)
                with torch.no_grad():
                    bias.zero_()
                bias.requires_grad_(False)
        self.fc = nn.Linear(SHORTCUT, n_outputs)

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        single = x.dim() == 3
        if single:
            x = x[:, None]
        b, s = x.shape[:2]
        h = x.reshape(b * s, *x.shape[2:])
        p = self.p_dropout
        branches = [branch(h, update_stats, p, generator).transpose(1, 2).reshape(b * s, -1)
                    for branch in (self.branch_small, self.branch_large)]
        seq = dropout(torch.cat(branches, dim=-1), p, self.training, generator).reshape(b, s, -1)
        shortcut = self.shortcut(seq)
        hcur = seq
        for lstm in (self.lstm_0, self.lstm_1):
            hcur = dropout(lstm(hcur)[0], p, self.training, generator)
        h = dropout(hcur + shortcut, p, self.training, generator)
        logits = self.fc(h)
        return logits[:, 0] if single else logits
