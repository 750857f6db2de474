"""Data parallelism over ``torch.distributed``: the port's communication layer.

Counterpart of ``sleepgen/parallel/mesh.py``. The JAX package lays one
program over a ``jax.sharding.Mesh`` whose ``data`` axis shards each batch,
and XLA adds the gradient reduction. Here each rank is one process with
one device (NCCL between cards, gloo only for CPU tensors), and the code
that needs a reduction asks the ``Mesh`` for it:

* every rank reads the same global batch and draws every random input of
  a step for the global batch from the same generator, then keeps its
  shard (``shard_batch``, ``Mesh.shard``), so no draw depends on the world
  size;
* gradients are averaged over the ranks (``Mesh.average_gradients``) on
  equal shards (``pad_to_multiple`` where the JAX package pads);
* ``layers.BatchNorm`` reduces its statistics over the mesh's group
  (``Mesh.bind``), as flax computes them over the sharded batch;
* losses, means and the stage-2 scale factor are reduced over the ranks
  (``Mesh.mean``, ``Mesh.gather``).

``make_mesh()`` without ``torch.distributed`` initialised is the world of
one: no collective runs, and every entry point's default is that mesh, as
``mesh or make_mesh()`` is in the JAX package. A tensor-parallel ``model``
axis is not offered: no JAX caller makes one.
"""
from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, device: str = "cuda", **kwargs) -> None:
    """``torch.distributed.init_process_group``: NCCL when ``device`` is
    CUDA, gloo only for the CPU (never a fallback from one to the other).
    Without arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a CUDA rank is bound to card
    ``LOCAL_RANK`` (else its rank modulo the card count) first."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if backend == "nccl":
        torch.cuda.set_device(_local_card(rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)


def _local_card(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % torch.cuda.device_count()


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: ``n_data`` ranks, this process's ``rank`` and
    ``device``, and the process group (None for the world of one without
    ``torch.distributed``, where no collective runs)."""

    n_data: int
    rank: int
    device: torch.device
    group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: 1}

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes checkpoints, logs and samples."""
        return self.rank == 0

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch (its leading axis must divide
        by ``n_data``)."""
        n = x.shape[0]
        if n % self.n_data:
            raise ValueError(f"batch {n} does not divide over {self.n_data} ranks")
        step = n // self.n_data
        return x[self.rank * step:(self.rank + 1) * step]

    def bind(self, model: torch.nn.Module) -> torch.nn.Module:
        """Every ``layers.BatchNorm`` of ``model`` reduces its statistics
        over this mesh's ranks (a world of one needs no reduction). In
        place; returns ``model``."""
        from sleepgen_torch.nn.layers import BatchNorm

        group = self.group if self.n_data > 1 else None
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.group = group
        return model

    def average_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Each gradient becomes its mean over the ranks (one all-reduce of
        the flattened gradients)."""
        if self.group is None:
            return
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.n_data
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of x over the ranks (of a per-rank mean over equal
        shards: the global mean)."""
        if self.group is None:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.group)
        return y / self.n_data

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.group)
        return y

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along the leading axis, in rank
        order: the global batch of a sharded one."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.n_data)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh of every rank of the initialised process group, or the world
    of one without ``torch.distributed``. ``device`` defaults to this
    rank's card under NCCL, the CPU under gloo, and "cuda" for the world
    of one; ``n_data`` must be the world size. ``n_model`` > 1 raises: no
    JAX caller shards a model."""
    if n_model != 1:
        raise NotImplementedError("a model axis is not offered: no JAX caller uses one")
    if not (dist.is_available() and dist.is_initialized()):
        if n_data not in (None, 1):
            raise ValueError(f"a mesh of {n_data} needs torch.distributed initialised "
                             "(initialize_distributed)")
        from sleepgen_torch.utils.device import resolve_device

        return Mesh(1, 0, resolve_device(device or "cuda"))
    world = dist.get_world_size()
    if n_data not in (None, world):
        raise ValueError(f"the mesh spans every rank: n_data {n_data} != world {world}")
    if device is None:
        device = (f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl"
                  else "cpu")
    return Mesh(world, dist.get_rank(), torch.device(device), dist.group.WORLD)


def batch_sharding(mesh: Mesh) -> dict:
    """The leading (batch) axis split over the data axis, as a descriptor."""
    return {"axis": 0, "over": DATA_AXIS, "parts": mesh.n_data}


def replicated(mesh: Mesh) -> dict:
    """A whole copy on every rank, as a descriptor."""
    return {"axis": None, "over": None, "parts": mesh.n_data}


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's slice of a host batch (a numpy array or tensor, or a
    tuple of them sharing the batch axis), on the mesh's device."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(mesh, b) for b in batch)
    return mesh.shard(torch.as_tensor(np.asarray(batch))).to(mesh.device)


def replicate(mesh: Mesh, module_or_state: Any) -> Any:
    """Rank 0's parameters and buffers (a module's, or a state dict's
    tensors) on every rank, in place; returns its argument."""
    if mesh.group is None:
        return module_or_state
    state = (module_or_state.state_dict() if isinstance(module_or_state, torch.nn.Module)
             else module_or_state)
    for t in state.values():
        if torch.is_tensor(t):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module_or_state


def pad_to_multiple(batch: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the batch axis with copies of the last row so it divides by
    ``multiple`` (the JAX package's loaders pad so a batch divides over its
    devices)."""
    b = batch.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0)


def prefetch_to_device(iterator: Iterable[Any], mesh: Mesh, size: int = 2,
                       dtype: Optional[torch.dtype] = None) -> Iterator[Any]:
    """This rank's shard of each host batch, copied from pinned memory
    without blocking, ``size`` batches in flight ahead of the consumer; for
    a labelled tuple (x, y, ...) only x is cast to ``dtype``."""
    queue: collections.deque = collections.deque()
    pin = mesh.device.type == "cuda"

    def put(a, cast):
        t = mesh.shard(torch.as_tensor(np.asarray(a)))
        if pin:
            t = t.pin_memory()
        t = t.to(mesh.device, non_blocking=pin)
        return t.to(dtype) if cast and dtype is not None else t

    def put_batch(batch):
        if isinstance(batch, tuple):
            return tuple(put(b, i == 0) for i, b in enumerate(batch))
        return put(batch, True)

    for batch in iterator:
        queue.append(put_batch(batch))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def split_seeds(mesh: Optional[Mesh], seeds: Sequence[int]) -> Sequence[int]:
    """This rank's contiguous share of a batch of seeds (all of them without
    a mesh); the batch must divide over the ranks, as the JAX sampler
    asserts."""
    if mesh is None or mesh.n_data == 1:
        return seeds
    assert len(seeds) % mesh.n_data == 0, (len(seeds), mesh.n_data)
    n = len(seeds) // mesh.n_data
    return seeds[mesh.rank * n:(mesh.rank + 1) * n]
