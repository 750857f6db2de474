"""Kernel K2: GroupNorm -> SiLU -> Conv1d(k=3, SAME) + bias over (B, C, L),
and its plain version.

Counterpart of the Pallas TPU kernels
``sleepgen/pallas_kernels/fused_resblock.py::fused_gn_silu_conv3_tiled``
(and ``fused_gn_silu_conv3``, the same function), written in CUDA C++ for
Hopper: ``sleepgen_torch/csrc/gn_silu_conv3.cu`` (its source note gives
the bound and the design). GroupNorm statistics are fp32, h is rounded to
the working dtype before the convolution, the convolution accumulates in
fp32, and the output has x's dtype. The weight is in torch's
(C_out, C_in, 3) layout, in fp32 or bf16 (an fp32 master under autocast),
and is rounded to x's dtype; the bf16 kernel reads it as
``conv_tiles(w, torch.bfloat16)``, the fp32 kernel as
``fp32_conv_tiles(w)``, which the wrapper makes once per weight, dtype and
version (see ``_cached_tiles``).

``gn_silu_conv3`` runs the plain PyTorch version only for a tensor on the
CPU. For a CUDA tensor it launches the kernel or raises; it never falls
back. Inference only: the kernel has no backward, as the Pallas kernels
have none, so on a CUDA tensor it raises when autograd would need one
(grad mode on and an input requiring grad) rather than cut the graph.
"""
from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F

from sleepgen_torch.kernels import _build
from sleepgen_torch.kernels.group_norm import (DTYPE_CODES, FORM_COUNTERS, check_group_inputs,
                                               count_launch, group_norm_silu_reference)
from sleepgen_torch.utils import profiling

# Counters (``utils.profiling``): K2's launches, and keyed by (B, C_in,
# C_out, L, G, dtype) by shape (``k2.launch_shapes``); the bf16 path's
# launches by how x reached the tiles (``k2.form.tma``: the tensor map,
# ``k2.form.elem``: element loads, where L % 8 != 0 or x is not 16-byte
# aligned); the weight re-layouts the kernels' paths made (misses of
# ``_cached_tiles``); and while the tracer records, the nanoseconds from the
# wrapper's entry to its return, the launches they cover, and the re-layouts
profiling.register("k2.launches", "k2.relayouts", *FORM_COUNTERS["k2"])
profiling.register("k2.host_ns", "k2.traced_launches", "k2.traced_relayouts", traced=True)

MAX_GROUPS = 64  # kMaxGroups in csrc/gn_stats.cuh
TILE_N, CHUNK = 128, 64  # tc::TN and tc::KC in csrc/gn_silu_conv3.cu
FP32_CHUNK = 32  # fp::KC; the fp32 tile's output channels are fp32_tile_n(C_out)
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would need a gradient through any of ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gn_silu_conv3_reference(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, num_groups: int,
                            eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: x (B, C_in, L), w (C_out, C_in, 3), b (C_out,)
    -> (B, C_out, L) in x's dtype, with an fp32 convolution."""
    h = group_norm_silu_reference(x, scale, bias, num_groups, eps, True)
    y = F.conv1d(h.float(), w.to(x.dtype).float(), padding=1)
    return (y + b.float()[:, None]).to(x.dtype)


def conv_tiles(w: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The bf16 kernel's weight layout: (C_out, C_in, 3) -> (ceil(C_out / 128),
    ceil(C_in / 64), 3, 128, 64) in ``dtype`` (default w's), zero padded. Entry [t, c, k, n] is the row
    W_k[128 t + n, 64 c : 64 c + 64], with its 16-byte chunk j (8 channels)
    stored at chunk j ^ (n % 8): the 128-byte swizzle that the kernel's
    products read. A block's 64 input channels of all three taps are then
    one contiguous copy."""
    c_out, c_in, _ = w.shape
    w = w.to(dtype or w.dtype)
    nt, nk = -(-c_out // TILE_N), -(-c_in // CHUNK)
    taps = F.pad(w.permute(2, 0, 1), (0, nk * CHUNK - c_in, 0, nt * TILE_N - c_out))
    t = taps.reshape(3, nt, TILE_N, nk, 8, 8).permute(1, 3, 0, 2, 4, 5)
    row = torch.arange(TILE_N, device=w.device)[:, None]
    t = t[:, :, :, row, torch.arange(8, device=w.device) ^ (row % 8)].contiguous()
    return t.view(nt, nk, 3, TILE_N, CHUNK)


def fp32_tile_n(c_out: int) -> int:
    """Output channels of an fp32 block (TN of gn_silu_conv3_fp32): 64 for
    C_out <= 64, else 128. The rule lives only here: the wrapper passes the
    tiles' last dimension to the library, which picks the kernel by it."""
    return 64 if c_out <= 64 else 128


def fp32_conv_tiles(w: torch.Tensor) -> torch.Tensor:
    """The fp32 kernel's weight layout: (C_out, C_in, 3) -> (ceil(C_out / TN),
    ceil(C_in / 32), 32, 3, TN) fp32, zero padded, TN = fp32_tile_n(C_out).
    Entry [t, c, i, k, n] is W[TN t + n, 32 c + i, k], so a block's chunk of
    32 input channels, all three taps and its TN output channels, is one
    contiguous run, read as float4 along the output channels."""
    c_out, c_in, _ = w.shape
    tn = fp32_tile_n(c_out)
    nt, nk = -(-c_out // tn), -(-c_in // FP32_CHUNK)
    w = F.pad(w.float(), (0, 0, 0, nk * FP32_CHUNK - c_in, 0, nt * tn - c_out))
    return w.reshape(nt, tn, nk, FP32_CHUNK, 3).permute(0, 2, 3, 4, 1).contiguous()


def weight_tiles(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The layout the kernel of ``dtype`` reads w in."""
    return conv_tiles(w, dtype) if dtype == torch.bfloat16 else fp32_conv_tiles(w)


# weight_tiles of each weight the kernel has seen: (id(w), dtype) -> (weak
# reference to w, w._version, tiles). Keyed by the tensor object, not its
# data_ptr, since a freed weight's memory may come back as another tensor at
# version 0; an entry goes when its weight is freed, and an in-place update
# of the weight (an optimiser step on an fp32 master) bumps its _version,
# which misses the entry. The key is the parameter itself, not a cast of it,
# so a trainer's eval or in-training sample re-lays out each weight once
# after each update, not at every launch.
_tiles_cache: dict = {}


def tiles_in_use() -> tuple:
    """The weight tiles that K2's launches read now, for ``tiles_current``:
    a CUDA graph captured over K2 reads them by address."""
    return tuple(_tiles_cache.items())


def tiles_current(in_use: tuple) -> bool:
    """Whether every tile of ``in_use`` (``tiles_in_use``') is still the
    cache's, for a live weight at the version it was laid out from: an
    in-place update, a re-layout or a freed weight makes it stale."""
    return all(_tiles_cache.get(key) is hit and (w := hit[0]()) is not None
               and w._version == hit[1] for key, hit in in_use)


def _count_relayout() -> None:
    profiling.count("k2.relayouts")
    profiling.count("k2.traced_relayouts")


def _cached_tiles(w: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    dtype = dtype or w.dtype
    if w.is_inference():  # no version counter: re-laid out on every call
        _count_relayout()
        return weight_tiles(w, dtype)
    key = (id(w), dtype)
    hit = _tiles_cache.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    _count_relayout()
    tiles = weight_tiles(w, dtype)
    _tiles_cache[key] = (weakref.ref(w, lambda _, k=key: _tiles_cache.pop(k, None)),
                         w._version, tiles)
    return tiles


def gn_silu_conv3(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor, num_groups: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """SiLU(GroupNorm(x)) convolved with w (k=3, SAME) plus b.

    x (B, C_in, L); scale, bias (C_in,) fp32; w (C_out, C_in, 3) in fp32
    or bf16, rounded to x's dtype; b (C_out,) in x's dtype. Returns
    (B, C_out, L) in x's dtype."""
    t0 = profiling.clock_ns()
    if x.device.type == "cpu":
        return gn_silu_conv3_reference(x, scale, bias, w, b, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if needs_grad(x, scale, bias, w, b):
        raise RuntimeError("gn_silu_conv3 has no backward: call it under torch.no_grad() "
                           "or inference_mode, or run GroupNorm32 and the convolution")
    check_group_inputs(x, scale, bias, num_groups)
    bsz, c_in, l = x.shape
    if num_groups > MAX_GROUPS:
        raise ValueError(f"at most {MAX_GROUPS} groups, got {num_groups}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid (65535)")
    if (w.dim() != 3 or w.shape[1:] != (c_in, 3) or w.dtype not in WEIGHT_DTYPES
            or w.device != x.device):
        raise ValueError(f"w must be a (C_out, {c_in}, 3) fp32 or bf16 tensor on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype}")
    c_out = w.shape[0]
    if (tuple(b.shape) != (c_out,) or b.dtype != x.dtype
            or b.device != x.device or not b.is_contiguous()):
        raise ValueError(f"b must be a contiguous ({c_out},) {x.dtype} tensor "
                         f"on {x.device}")
    lib = _build.load()
    w = _cached_tiles(w, x.dtype)
    y = torch.empty((bsz, c_out, l), dtype=x.dtype, device=x.device)
    # fp32: the statistics' partial sums; bf16: each row's per-channel
    # affine (a / 2, d / 2), padded to whole chunks
    n_scratch = (lib.sg_gn_scratch_floats(bsz, c_in, l, num_groups) if x.dtype == torch.float32
                 else 2 * bsz * -(-c_in // CHUNK) * CHUNK)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    form = ctypes.c_int(-1)
    code = lib.sg_gn_silu_conv3(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
        b.data_ptr(), y.data_ptr(), scratch.data_ptr(), bsz, c_in, c_out, l,
        num_groups, eps, DTYPE_CODES[x.dtype], w.shape[-1],
        torch.cuda.current_stream().cuda_stream, ctypes.byref(form))
    _build.check(lib, code, "gn_silu_conv3")
    count_launch("k2", (bsz, c_in, c_out, l, num_groups, str(x.dtype)), t0,
                 form.value if form.value >= 0 else None)
    return y


# The Pallas ``fused_gn_silu_conv3`` (``sleepgen/pallas_kernels/fused_resblock.py:180``,
# one batch element per program) computes the same function as the batch-tiled
# ``fused_gn_silu_conv3_tiled``; on the card K2's grid covers the batch either way.
fused_gn_silu_conv3 = gn_silu_conv3
