"""Validation reductions.

The port's own copy of ``sleepgen/train/evals.py``. Eval steps return
per-sample losses, and the mean is taken over samples, not over batch
means, so a short last batch weighs what its samples weigh. The port's
loader pads no batch (one device), so the JAX package's per-batch
padding trim is not carried over.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def masked_epoch_mean(n_total: int, batches: Iterable[np.ndarray],
                      losses_fn: Callable[[int, np.ndarray], torch.Tensor]) -> float:
    """Mean of per-sample losses over one validation epoch:
    ``losses_fn(batch_index, batch) -> (B,)``; rows past ``n_total``
    samples are left out."""
    total, count = 0.0, 0
    for bi, batch in enumerate(batches):
        losses = losses_fn(bi, batch).double().cpu().numpy()
        n_valid = min(losses.shape[0], n_total - count)
        if n_valid <= 0:
            break
        total += float(losses[:n_valid].sum())
        count += n_valid
    return total / max(count, 1)
