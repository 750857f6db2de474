"""Downstream sleep-stage decoder training.

Counterpart of ``sleepgen/train/decode.py`` (the reference's skorch
``EEGClassifier``, ``src/testing/run_sleep_decode.py:195-245``): AdamW at
lr 1e-3 and weight decay 1e-3 on every parameter (optax's ``adamw``, which
is torch's decoupled ``AdamW`` on one parameter group), class-balanced
cross-entropy, a cosine learning rate, balanced accuracy on the valid and
the train set after every epoch, and the valid set's confusion matrix at
the end. fp32 throughout, as the JAX trainer runs it.

The learning rate is optax's ``cosine_decay_schedule(lr, D)`` with D =
max(1, (n_epochs - 1) floor(N / B)): lr (1 + cos(pi min(t, D) / D)) / 2 at
step t. An epoch runs ceil(N / B) steps, so t passes D and the rate holds
at 0 (a ``LambdaLR`` with that clamp; ``CosineAnnealingLR`` would turn back
up).

The loop keeps the JAX trainer's order: a ``default_rng(seed)``
permutation per epoch, batches of ``batch_size`` (the last may be short),
then a prediction pass over the valid set and one over the train set.
Each training step normalises with the batch's BatchNorm statistics and
moves the running ones, as flax's ``mutable=["batch_stats"]``; prediction
runs in eval mode on the running ones.

Differences from the JAX trainer, each forced: initial weights come from
numpy (``utils/weights.flax_init_state``) and dropout masks from a
``torch.Generator`` seeded with ``seed``, as torch cannot reproduce JAX's
threefry stream.

Data parallelism (``mesh``): a training batch is padded to a multiple of
the ranks with copies of its last window and label, as the JAX trainer
pads it, and each rank takes its shard; dropout masks are drawn for the
global batch and sliced (``layers.batch_shard``), BatchNorm computes the
global batch's statistics, the weighted cross-entropy divides by the
global batch's weight, and gradients are averaged over the ranks. Each
rank predicts every window itself (no collective).

Inputs are the JAX package's numpy arrays, windows (N, T, C) or
sequences (N, S, T, C); each batch goes to the device as (.., C, T).
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sleepgen_torch.data.staging import balanced_class_weights
from sleepgen_torch.nn.layers import batch_shard
from sleepgen_torch.parallel.mesh import Mesh, make_mesh, pad_to_multiple
from sleepgen_torch.utils.weights import flax_init_state, load_numpy_state


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor,
                           total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_i w[y_i] nll_i / max(sum_i w[y_i], 1e-8), in fp32; the
    denominator is ``total_weight`` when given (a data-parallel rank's
    share of the global batch's)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    w = class_weights[labels]
    return (w * nll).sum() / (w.sum().clamp_min(1e-8) if total_weight is None
                              else total_weight)


def balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int = 5) -> float:
    """Mean recall over the classes present (sklearn's
    balanced_accuracy_score)."""
    recalls = [float((y_pred[y_true == c] == c).mean())
               for c in range(n_classes) if (y_true == c).any()]
    return float(np.mean(recalls)) if recalls else 0.0


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int = 5) -> np.ndarray:
    """(n_classes, n_classes) int64 counts, rows true, columns predicted."""
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def cosine_decay(lr: float, n_epochs: int, n_train: int,
                 batch_size: int) -> Callable[[int], float]:
    """The learning rate at step t, optax's cosine_decay_schedule over
    max(1, (n_epochs - 1) floor(N / B)) steps, held at 0 past them."""
    decay_steps = max(1, (n_epochs - 1) * max(1, n_train // batch_size))
    return lambda t: lr * 0.5 * (1.0 + math.cos(math.pi * min(t, decay_steps) / decay_steps))


@dataclass
class DecodeResult:
    best_valid_bal_acc: float
    history: list
    confusion: np.ndarray
    params: Dict[str, torch.Tensor]  # the final state dict
    # classify new windows (N, T, C) with the final decoder -> (N,) labels
    predict: Any = None
    # per epoch, on the host clock: the training steps' seconds (to the
    # last loss on the host) and the two prediction passes'
    epoch_seconds: list = field(default_factory=list)


def to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Windows (.., T, C) numpy -> (.., C, T) fp32 on ``dev``."""
    return torch.as_tensor(np.ascontiguousarray(np.swapaxes(x, -1, -2)), dtype=torch.float32,
                           device=dev)


def make_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                    sched: torch.optim.lr_scheduler.LRScheduler, class_weights: torch.Tensor,
                    generator: Optional[torch.Generator] = None, mesh: Optional[Mesh] = None):
    """``step(x, y) -> loss`` on a device batch (x (B, .., C, T), y (B,)):
    the loss with the batch's BatchNorm statistics (the running ones
    moved), its gradient, one AdamW step and one schedule step. The loss
    is a detached 0-d tensor; the gradients stay in ``.grad``. With a
    ``mesh``, x and y are this rank's equal shard of the global batch
    (module docstring); the loss is the global batch's."""
    if mesh is not None:
        mesh.bind(model)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        model.train()
        opt.zero_grad(set_to_none=True)
        shard = (batch_shard(mesh.rank, mesh.n_data) if mesh is not None
                 else contextlib.nullcontext())
        with shard:
            logits = model(x, update_stats=True, generator=generator)
        total = None
        if mesh is not None:  # each rank's share of the mean over the ranks
            total = mesh.sum(class_weights[y].sum()).clamp_min(1e-8) / mesh.n_data
        loss = weighted_cross_entropy(logits, y, class_weights, total)
        loss.backward()
        if mesh is not None:
            mesh.average_gradients(model.parameters())
            loss = mesh.mean(loss)
        opt.step()
        sched.step()
        return loss.detach()

    return step


def make_optimizer(model: nn.Module, lr: float, weight_decay: float, n_epochs: int,
                   n_train: int, batch_size: int):
    """(AdamW over every trainable parameter, its LambdaLR schedule)."""
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=lr,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(1.0, n_epochs, n_train,
                                                                batch_size))
    return opt, sched


def train_decoder(
    model: nn.Module,
    train_xy: Tuple[np.ndarray, np.ndarray],
    valid_xy: Tuple[np.ndarray, np.ndarray],
    n_epochs: int = 10,
    batch_size: int = 64,
    lr: float = 1e-3,
    weight_decay: float = 1e-3,
    n_classes: int = 5,
    seed: int = 2,
    device: torch.device | str = "cuda",
    mesh: Optional[Mesh] = None,
) -> DecodeResult:
    """Train a (B, .., C, T) -> logits decoder with the reference's recipe
    on pre-epoched numpy arrays, from initial weights drawn from ``seed``
    (``flax_init_state``). ``mesh``: data-parallel over its ranks (default:
    the world of one on ``device``)."""
    mesh = mesh or make_mesh(device=device)
    dev = mesh.device
    x_train, y_train = train_xy
    x_valid, y_valid = valid_xy
    load_numpy_state(model, flax_init_state(model, seed))
    model.to(dev)
    opt, sched = make_optimizer(model, lr, weight_decay, n_epochs, len(x_train), batch_size)
    class_w = torch.as_tensor(balanced_class_weights(y_train, n_classes), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    step = make_train_step(model, opt, sched, class_w, gen, mesh)

    def predict(x: np.ndarray) -> np.ndarray:
        model.eval()
        preds = []
        with torch.inference_mode():
            for i in range(0, len(x), batch_size):
                preds.append(model(to_device(x[i:i + batch_size], dev)).argmax(-1).cpu().numpy())
        return np.concatenate(preds)

    history, seconds, best = [], [], 0.0
    np_rng = np.random.default_rng(seed)
    for epoch in range(n_epochs):
        t0 = time.perf_counter()
        order = np_rng.permutation(len(x_train))
        losses = []
        for i in range(0, len(order), batch_size):
            idx = mesh.shard(pad_to_multiple(order[i:i + batch_size], mesh.n_data))
            losses.append(step(to_device(x_train[idx], dev),
                               torch.as_tensor(y_train[idx], device=dev)))
        loss = float(torch.stack(losses).double().mean())
        t1 = time.perf_counter()
        vacc = balanced_accuracy(y_valid, predict(x_valid), n_classes)
        tacc = balanced_accuracy(y_train, predict(x_train), n_classes)
        seconds.append({"train_s": t1 - t0, "predict_s": time.perf_counter() - t1})
        history.append({"epoch": epoch, "loss": loss, "train_bal_acc": tacc,
                        "valid_bal_acc": vacc})
        best = max(best, vacc)

    cm = confusion_matrix(y_valid, predict(x_valid), n_classes)
    return DecodeResult(best, history, cm, model.state_dict(), predict, seconds)
