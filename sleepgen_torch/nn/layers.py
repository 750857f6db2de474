"""Shared building blocks of the port's networks, in torch's (B, C, L) layout.

Counterparts of ``sleepgen/nn/layers.py``. Parameters of every GroupNorm
stay fp32; convolutions and linear layers run in the model's compute dtype
(``cast_compute_dtype``). Normalisation statistics and the attention
softmax are fp32 in either dtype. ``BatchNorm`` is flax's, for every port
model that has one (the discriminator, USleep and the sleep stagers), and
``dropout`` draws its mask from an explicit generator.

Data parallelism (``sleepgen_torch.parallel``): a ``BatchNorm`` whose
``group`` is set reduces its statistics over that process group, so every
rank normalises with the global batch's and moves identical running ones;
inside ``batch_shard(rank, world)`` a dropout mask is drawn for the global
batch (``world`` times the local leading axis) and this rank's rows are
kept, so the masks do not depend on the world size.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.kernels.attention import attention
from sleepgen_torch.kernels.group_norm import group_norm_silu


def conv1d(in_channels: int, out_channels: int, kernel: int = 3,
           stride: int = 1, padding: int | None = None) -> nn.Conv1d:
    """1-D convolution on (B, C, L); padding defaults to SAME (k // 2)."""
    return nn.Conv1d(in_channels, out_channels, kernel, stride=stride,
                     padding=kernel // 2 if padding is None else padding)


class GroupNorm32(nn.Module):
    """GroupNorm with eps 1e-6 and fp32 statistics, optionally followed by
    SiLU (``fuse_silu``), over (B, C, L). Runs kernel K1 on CUDA tensors
    and its plain version on CPU tensors; output in the input's dtype."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-6, fuse_silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x.contiguous(), self.weight, self.bias, self.num_groups,
                               self.eps, self.fuse_silu)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over (B, C, ...), statistics over every axis
    but C, in fp32: epsilon 1e-5, momentum 0.9, biased running variance.

    In training mode it normalises with the batch's statistics, as flax's
    ``use_running_average=False``; its running mean and variance move only
    when the caller asks (``update_stats``), as flax's
    ``mutable=["batch_stats"]`` only counts when the update is kept, and
    decay as flax's momentum 0.9: ``r = 0.9 r + 0.1 batch``. (torch's
    BatchNorm would keep the unbiased variance and move in every training
    pass.) In eval mode it normalises with the running statistics. With
    ``count_batches`` it also holds torch's ``num_batches_tracked``, so a
    torch BatchNorm's state dict (braindecode's models) loads strictly."""

    MOMENTUM, EPS = 0.9, 1e-5
    group = None  # a process group: statistics over the global batch (Mesh.bind)

    def __init__(self, channels: int, count_batches: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        if count_batches:
            self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        else:
            self.num_batches_tracked = None

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.EPS)
        dims = [d for d in range(x.dim()) if d != 1]
        if self.group is not None:
            return self._global_forward(x, dims, update_stats)
        if update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=dims, correction=0)
                self._move_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                            eps=self.EPS)

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.lerp_(mean, 1.0 - self.MOMENTUM)
        self.running_var.lerp_(var, 1.0 - self.MOMENTUM)
        if self.num_batches_tracked is not None:
            self.num_batches_tracked += 1

    def _global_forward(self, x: torch.Tensor, dims, update_stats: bool) -> torch.Tensor:
        """The training forward with the statistics of the batch over every
        rank of ``group``: sums all-reduced with autograd, so the gradient
        reaches each rank's rows through the other ranks' losses too."""
        from torch.distributed.nn.functional import all_reduce

        world = torch.distributed.get_world_size(self.group)
        n = world * (x.numel() // x.shape[1])
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        mean = all_reduce(x.sum(dims), group=self.group) / n
        d = x - mean.view(shape)
        var = all_reduce(d.square().sum(dims), group=self.group) / n
        if update_stats:
            with torch.no_grad():
                self._move_running(mean, var)
        scale = torch.rsqrt(var + self.EPS) * self.weight
        return d * scale.view(shape) + self.bias.view(shape)


_BATCH_SHARD = contextvars.ContextVar("batch_shard", default=(0, 1))


@contextlib.contextmanager
def batch_shard(rank: int, world: int):
    """Within this context ``dropout`` draws each mask for the global batch
    of ``world`` shards and keeps shard ``rank``'s rows (leading axes are
    batch-major, as every port model's are)."""
    token = _BATCH_SHARD.set((rank, world))
    try:
        yield
    finally:
        _BATCH_SHARD.reset(token)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator`` (on x's
    device): kept entries scaled by 1 / (1 - p). The identity when not
    ``training`` or when p is 0. Inside ``batch_shard`` the mask is this
    shard's rows of the global batch's mask."""
    if not training or p == 0.0:
        return x
    rank, world = _BATCH_SHARD.get()
    n = x.shape[0]
    u = torch.rand((n * world, *x.shape[1:]), generator=generator, device=x.device)
    keep = u[rank * n:(rank + 1) * n] >= p
    return x * keep / (1.0 - p)


def cast_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter to ``dtype`` except GroupNorm's, which stay fp32
    (the kernels take the affine in fp32). In place; returns ``model``."""
    for m in model.modules():
        if isinstance(m, GroupNorm32):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return model


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings (B,) -> (B, dim), [cos | sin], fp32,
    zero-padded when dim is odd."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def check_kv_block(length: int, block: int) -> None:
    """Refuse a ``kv_block_size`` that the JAX package refuses: a block
    above 0 and below the attention length L must divide L. Raises
    AssertionError with the message of ``sleepgen/nn/blockwise_attention.py``.

    In the JAX package the block selects blockwise (online-softmax)
    attention for long windows, which computes the same softmax; the port
    keeps the refusal and computes the attention as ``attention`` does
    whatever the block (one ``scaled_dot_product_attention`` at lengths
    past K5's ``MAX_L``)."""
    if block and length > block and length % block:
        raise AssertionError(
            f"kv_block_size={block} must divide the attention length "
            f"L={length}. The UNet attends at image_size/ds for each ds in "
            f"attention_resolutions — pick a block size dividing all of them "
            f"(powers of two are always safe for power-of-two windows).")


class SelfAttention1d(nn.Module):
    """Self-attention over the length axis of (B, C, L), without residual:
    ``attention`` of one 1x1 qkv convolution (three, ``q``, ``k`` and
    ``v``, with ``split_qkv``, as the first-generation VAE names them),
    then a 1x1 output projection. ``conv`` makes the 1x1 convolutions
    (``conv1d``, or ``quant.QuantConv1d`` for int8 sampling);
    ``mixed_precision`` as ``attention``'s (``set_fast_math`` sets it)."""

    def __init__(self, channels: int, num_heads: int = 1, split_qkv: bool = False,
                 conv=conv1d, mixed_precision: bool = True):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.mixed_precision = mixed_precision
        if split_qkv:
            self.q, self.k, self.v = (conv(channels, channels, 1) for _ in range(3))
        else:
            self.qkv = conv(channels, 3 * channels, 1)
        self.proj_out = conv(channels, channels, 1)

    def project_qkv(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3C, L): q, k and v stacked along the channels."""
        if hasattr(self, "qkv"):
            return self.qkv(x)
        return torch.cat([self.q(x), self.k(x), self.v(x)], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(attention(self.project_qkv(x), self.num_heads,
                                       self.mixed_precision))


def set_fast_math(model: nn.Module, fast: bool) -> nn.Module:
    """The JAX package's ``fast_math`` switch on every attention of
    ``model`` (``attention``'s ``mixed_precision``). GroupNorm has nothing
    to switch: K1, K2 and their plain versions compute the normalisation
    in fp32 and round once to the compute dtype, which is JAX's strict
    GroupNorm (its fast-math GroupNorm normalises in bf16). In place;
    returns ``model``."""
    for m in model.modules():
        if isinstance(m, SelfAttention1d):
            m.mixed_precision = fast
    return model


class AttentionBlock1d(SelfAttention1d):
    """GroupNorm (no SiLU) -> self-attention -> residual add. Parameters are
    named as the reference UNet's AttentionBlock (norm, qkv, proj_out), or
    as the first-generation VAE's AttnBlock (norm, q, k, v, proj_out) with
    ``split_qkv``."""

    def __init__(self, channels: int, num_heads: int = 1, num_groups: int = 32,
                 split_qkv: bool = False, conv=conv1d):
        super().__init__(channels, num_heads, split_qkv, conv)
        self.norm = GroupNorm32(channels, num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + super().forward(self.norm(x))
