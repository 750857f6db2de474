"""Kernel K2: GroupNorm -> SiLU -> Conv1d(k=3, SAME) + bias over (B, C, L),
and its plain version.

Counterpart of the Pallas TPU kernels
``sleepgen/pallas_kernels/fused_resblock.py::fused_gn_silu_conv3_tiled``
(and ``fused_gn_silu_conv3``, the same function), written in CUDA C++ for
Hopper: ``sleepgen_torch/csrc/gn_silu_conv3.cu`` (its source note gives
the bound and the design). GroupNorm statistics are fp32, h is rounded to
the working dtype before the convolution, the convolution accumulates in
fp32, and the output has x's dtype. The weight is in torch's
(C_out, C_in, 3) layout.

``gn_silu_conv3`` runs the plain PyTorch version only for a tensor on the
CPU. For a CUDA tensor it launches the kernel or raises; it never falls
back. Inference only: the kernel has no backward, as the Pallas kernels
have none, so on a CUDA tensor it raises when autograd would need one
(grad mode on and an input requiring grad) rather than cut the graph.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from sleepgen_torch.kernels import _build
from sleepgen_torch.kernels.group_norm import (DTYPE_CODES, check_group_inputs,
                                               group_norm_silu_reference)

# Launches of the CUDA kernel in this process, and the same launches by
# (B, C_in, C_out, L, G, dtype). chip_smoke.py zeroes both before it
# drives the main path and reads them after.
launches = 0
launch_shapes: collections.Counter = collections.Counter()

MAX_GROUPS = 64  # kMaxGroups in csrc/gn_stats.cuh


def reset_counts() -> None:
    global launches
    launches = 0
    launch_shapes.clear()


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


def gn_silu_conv3(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor, num_groups: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """SiLU(GroupNorm(x)) convolved with w (k=3, SAME) plus b.

    x (B, C_in, L); scale, bias (C_in,) fp32; w (C_out, C_in, 3) and
    b (C_out,) in x's dtype. Returns (B, C_out, L) in x's dtype."""
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
    if (w.dim() != 3 or w.shape[1:] != (c_in, 3) or w.dtype != x.dtype
            or w.device != x.device or not w.is_contiguous()):
        raise ValueError(f"w must be a contiguous (C_out, {c_in}, 3) {x.dtype} "
                         f"tensor on {x.device}, got {tuple(w.shape)} {w.dtype}")
    c_out = w.shape[0]
    if (tuple(b.shape) != (c_out,) or b.dtype != x.dtype
            or b.device != x.device or not b.is_contiguous()):
        raise ValueError(f"b must be a contiguous ({c_out},) {x.dtype} tensor "
                         f"on {x.device}")
    lib = _build.load()
    y = torch.empty((bsz, c_out, l), dtype=x.dtype, device=x.device)
    scratch = torch.empty(lib.sg_gn_scratch_floats(bsz, c_in, l, num_groups),
                          dtype=torch.float32, device=x.device)
    code = lib.sg_gn_silu_conv3(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(),
        b.data_ptr(), y.data_ptr(), scratch.data_ptr(), bsz, c_in, c_out, l,
        num_groups, eps, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "gn_silu_conv3")
    global launches
    launches += 1
    launch_shapes[(bsz, c_in, c_out, l, num_groups, str(x.dtype))] += 1
    return y


# The Pallas ``fused_gn_silu_conv3`` (``sleepgen/pallas_kernels/fused_resblock.py:180``,
# one batch element per program) computes the same function as the batch-tiled
# ``fused_gn_silu_conv3_tiled``; on the card K2's grid covers the batch either way.
fused_gn_silu_conv3 = gn_silu_conv3
