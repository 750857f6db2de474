"""Kernel K1: GroupNorm (+SiLU) over (B, C, L), and its plain version.

Counterpart of the Pallas TPU kernel
``sleepgen/pallas_kernels/group_norm.py::fused_group_norm_silu``, written
in CUDA C++ for Hopper: ``sleepgen_torch/csrc/group_norm_silu.cu`` (its
source note gives the bound and the design). Statistics are fp32 for
either input dtype, eps defaults to 1e-6 (not torch's 1e-5), and the
output has the input's dtype.

``group_norm_silu`` runs the plain PyTorch version only for a tensor on
the CPU. For a CUDA tensor it launches the kernel or raises; it never
falls back.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from sleepgen_torch.kernels import _build

# Launches of the CUDA kernel in this process, and the same launches by
# (B, C, L, G, apply_silu, dtype). chip_smoke.py zeroes both before it
# drives the main path and reads them after.
launches = 0
launch_shapes: collections.Counter = collections.Counter()

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    global launches
    launches = 0
    launch_shapes.clear()


def group_norm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float = 1e-6,
                              apply_silu: bool = True) -> torch.Tensor:
    """Plain PyTorch GroupNorm (+SiLU): x (B, C, L); scale, bias (C,)."""
    b, c, l = x.shape
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, l)
    y = y * scale.float()[:, None] + bias.float()[:, None]
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def check_group_inputs(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, num_groups: int) -> None:
    """Raise unless x (B, C, L) and the (C,) fp32 affine suit the kernels."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, L), got shape {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current CUDA device is "
                         f"cuda:{torch.cuda.current_device()}")
    b, c, l = x.shape
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if (c // num_groups) * l >= 2**31 or b * num_groups >= 2**31:
        raise ValueError(f"shape {tuple(x.shape)} is too large for the kernel")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}")


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-6,
                    apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm + per-channel affine (+SiLU) over x (B, C, L).

    scale and bias are (C,) fp32. Returns (B, C, L) in x's dtype."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, num_groups, eps,
                                         apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_group_inputs(x, scale, bias, num_groups)
    b, c, l = x.shape
    lib = _build.load()
    y = torch.empty_like(x)
    scratch = torch.empty(lib.sg_gn_scratch_floats(b, c, l, num_groups),
                          dtype=torch.float32, device=x.device)
    code = lib.sg_group_norm_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        scratch.data_ptr(), b, c, l, num_groups, eps, int(apply_silu),
        DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "group_norm_silu")
    global launches
    launches += 1
    launch_shapes[(b, c, l, num_groups, bool(apply_silu), str(x.dtype))] += 1
    return y
