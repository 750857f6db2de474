"""Chambon et al. 2018's sleep stager and its 3-window sequence model, on
(B, C, T).

Counterparts of ``sleepgen/nn/chambon.py`` (braindecode's
``SleepStagerChambon2018`` as the reference's ``run_sleep_decode.py``
configures it): an optional spatial convolution mixing the C channels
into C virtual ones, then two [conv k 0.5 s -> BatchNorm (or none) ->
ReLU -> max-pool 0.125 s] stages with 8 filters shared across virtual
channels, the features flattened in torch's (F, V, T') order.

Submodules carry braindecode's names and shapes: ``spatial_conv``
(Conv2d (V, 1, C, 1), only when C > 1), ``feature_extractor.{0,4}``
(Conv2d (F, in, 1, k)), ``feature_extractor.{1,5}`` (BatchNorm with
``num_batches_tracked``), the head ``final_layer.1`` (the name of the
reference's variant-b checkpoint), and the 3-window wrapper's
``0.module.`` (TimeDistributed) and ``1.2`` (its Linear). So a reference
decode checkpoint loads with ``strict=True``, and
``sleepgen.utils.torch_import.import_chambon`` /
``import_chambon_sequence`` read the port's state dicts.

At 100 Hz: kernel k = ceil(0.5 sfreq) = 50, pool ceil(0.125 sfreq) = 13
(VALID, stride = pool), padding ceil(pad_size_s sfreq) on each side: 10
for the 3-window stager (pad_size_s 0.1), 25 for the single-window one's
default 0.25. The JAX package computes the convolutions as
``Im2ColConv1d``, a workaround for the TPU compiler's slow backward of a
wide-kernel convolution with one input channel; its function is a plain
convolution, which is what the port computes.

BatchNorm is flax's (``layers.BatchNorm``): in training mode the batch's
statistics, moved into the running ones only when ``update_stats``;
in eval mode the running ones. Dropout (rate ``p_dropout``) draws from
the caller's generator (``layers.dropout``). Windows are 30 s at 100 Hz,
3000 samples, which sizes the heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.data.transforms import WINDOW_SIZE
from sleepgen_torch.nn.layers import BatchNorm, dropout


class ChambonFeatureExtractor(nn.Module):
    """x (B, C, T) -> flattened features (B, F V T')."""

    def __init__(self, n_chans: int = 1, sfreq: float = 100.0, n_conv_chs: int = 8,
                 time_conv_size_s: float = 0.5, max_pool_size_s: float = 0.125,
                 pad_size_s: float = 0.1, apply_batch_norm: bool = True):
        super().__init__()
        k = int(math.ceil(time_conv_size_s * sfreq))
        self.pool = max(1, int(math.ceil(max_pool_size_s * sfreq)))
        pad = int(math.ceil(pad_size_s * sfreq))
        self._geometry = (n_chans, n_conv_chs, k, pad)
        if n_chans > 1:
            self.spatial_conv = nn.Conv2d(1, n_chans, (n_chans, 1))

        def norm():
            return BatchNorm(n_conv_chs, count_batches=True) if apply_batch_norm else nn.Identity()

        self.feature_extractor = nn.Sequential(
            nn.Conv2d(1, n_conv_chs, (1, k), padding=(0, pad)), norm(), nn.ReLU(),
            nn.MaxPool2d((1, self.pool)),
            nn.Conv2d(n_conv_chs, n_conv_chs, (1, k), padding=(0, pad)), norm(), nn.ReLU(),
            nn.MaxPool2d((1, self.pool)))

    def n_features(self, n_times: int) -> int:
        """Length of the flattened features of a window of ``n_times``."""
        v, f, k, pad = self._geometry
        for _ in range(2):
            n_times = (n_times + 2 * pad - k + 1) // self.pool
        return f * v * n_times

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        h = x.unsqueeze(1)  # (B, 1, C, T)
        if hasattr(self, "spatial_conv"):
            h = self.spatial_conv(h).transpose(1, 2)  # (B, 1, V, T)
        fe = self.feature_extractor
        for conv, norm in ((fe[0], fe[1]), (fe[4], fe[5])):
            h = conv(h)
            h = norm(h, update_stats) if isinstance(norm, BatchNorm) else norm(h)
            h = F.max_pool2d(F.relu(h), (1, self.pool))
        return h.flatten(start_dim=1)  # (F, V, T') order


class SleepStagerChambon2018(ChambonFeatureExtractor):
    """The single-window stager: features -> dropout -> linear. x (B, C,
    3000) -> logits (B, n_outputs)."""

    def __init__(self, n_chans: int = 1, sfreq: float = 100.0, n_outputs: int = 5,
                 dropout: float = 0.25, apply_batch_norm: bool = False,
                 pad_size_s: float = 0.25):
        super().__init__(n_chans, sfreq, pad_size_s=pad_size_s,
                         apply_batch_norm=apply_batch_norm)
        self.p_dropout = dropout
        self.final_layer = nn.Sequential(nn.Dropout(dropout),
                                         nn.Linear(self.n_features(WINDOW_SIZE), n_outputs))

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = dropout(super().forward(x, update_stats), self.p_dropout, self.training, generator)
        return self.final_layer[1](h)


class TimeDistributed(nn.Module):
    """braindecode's ``TimeDistributed``: ``module`` applied to each window
    of (B, S, C, T), its outputs concatenated -> (B, S F)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        b, s = x.shape[:2]
        return self.module(x.reshape(b * s, *x.shape[2:]), update_stats).reshape(b, -1)


class TimeDistributedStager(nn.Sequential):
    """The 3-window sequence model (run_sleep_decode.py:174-190): Chambon
    features of each window (shared weights, BatchNorm on, pad_size_s
    0.1), concatenated, dropout(0.5), linear. x (B, n_windows, C, 3000) ->
    logits (B, n_outputs). ``feat_dropout`` is deliberately unused, as in
    the reference: its 0.9 belongs to the single-window head, which the
    features are taken before."""

    def __init__(self, n_chans: int = 1, sfreq: float = 100.0, n_outputs: int = 5,
                 n_windows: int = 3, feat_dropout: float = 0.9, head_dropout: float = 0.5,
                 pad_size_s: float = 0.1):
        extractor = ChambonFeatureExtractor(n_chans, sfreq, pad_size_s=pad_size_s,
                                            apply_batch_norm=True)
        super().__init__(TimeDistributed(extractor),
                         nn.Sequential(nn.Flatten(), nn.Dropout(head_dropout),
                                       nn.Linear(n_windows * extractor.n_features(WINDOW_SIZE),
                                                 n_outputs)))
        self.n_windows = n_windows
        self.p_dropout = head_dropout

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if x.shape[1] != self.n_windows:
            raise ValueError(f"expected {self.n_windows} windows, got {x.shape[1]}")
        feats = dropout(self[0](x, update_stats), self.p_dropout, self.training, generator)
        return self[1][2](feats)
