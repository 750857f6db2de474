"""Kernels K1 (GroupNorm (+SiLU) over (B, C, L)) and K3 (its backward),
and their plain versions.

K1 is the counterpart of the Pallas TPU kernel
``sleepgen/pallas_kernels/group_norm.py::fused_group_norm_silu``, written
in CUDA C++ for Hopper: ``sleepgen_torch/csrc/group_norm_silu.cu``. K3 is
the counterpart of that kernel's VJP, with the closed form of
``sleepgen/nn/fused_norm.py``: ``sleepgen_torch/csrc/group_norm_silu_bwd.cu``.
Each source note gives the kernel's bound and design. Both kernels are
bound by bytes, and each picks its form by the group's shape alone:

* a group of at most ``ON_CHIP_MAX`` elements is held by one block on
  chip (one launch for K1, two for K3);
* an aligned group (L a multiple of a 16-byte vector, 16-byte aligned
  bases) of up to ``CLUSTER_MAX`` elements is held by one thread-block
  cluster of up to 8 blocks that exchange their partial sums through
  distributed shared memory (``csrc/gn_cluster.cuh``; one launch for K1,
  two for K3), so x (and dy) are read once;
* only a larger group, or a ragged or unaligned one, still streams in
  2048-element chunks and reads its input twice (K1's streaming path,
  K3's three-pass form).

The launchers report the form they took, counted as ``k1.form.<form>``
and ``k3.form.<form>`` (``utils.profiling``);
a launch the card refuses raises and is never run in another form.
Statistics are fp32 for either input dtype, eps defaults to 1e-6 (not
torch's 1e-5), outputs and dx have the input's dtype, and the parameter
gradients are fp32.

``group_norm_silu`` is a ``torch.autograd.Function``: its forward saves
x, scale, bias and the per-(batch row, group) mean and rstd, and its
backward runs K3. Both run their plain PyTorch versions only for tensors
on the CPU; for CUDA tensors they launch the kernel or raise, and never
fall back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sleepgen_torch.kernels import _build
from sleepgen_torch.utils import profiling

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Largest group, (C / G) * L elements, that one block holds on chip
# (kOnChipMax in csrc/gn_group.cuh), and that one cluster of 8 blocks holds
# (kClusterMax in csrc/gn_cluster.cuh)
ON_CHIP_MAX = 12288
CLUSTER_MAX = 8 * ON_CHIP_MAX
# The launchers' form codes by kernel: sg::Form in csrc/gn_cluster.cuh; K2's,
# the bf16 path's load of x, from launch_tc in csrc/gn_silu_conv3.cu
FORMS = {"K1": ("on_chip", "cluster", "streaming"), "K3": ("on_chip", "cluster", "three_pass"),
         "K2": ("tma", "elem")}

# Counters (``utils.profiling``): K1's and K3's launches, by form and,
# keyed by (B, C, L, G, apply_silu, dtype), by shape (``k1.launch_shapes``,
# ``k3.launch_shapes``); K3's calls whose dy came strided and was copied to
# a contiguous tensor first, keyed by that shape and dy's strides
# (``k3.strided_dy_shapes``); and while the tracer records, the nanoseconds
# from a wrapper's entry to its return and the launches they cover
FORM_COUNTERS = {kid.lower(): tuple(f"{kid.lower()}.form.{form}" for form in forms)
                 for kid, forms in FORMS.items()}
profiling.register("k1.launches", "k3.launches", *FORM_COUNTERS["k1"], *FORM_COUNTERS["k3"])
profiling.register("k1.host_ns", "k1.traced_launches", "k3.host_ns", "k3.traced_launches",
                   traced=True)


def count_launch(kid: str, shape: tuple, t0: int, form: int | None = None) -> None:
    """Count one launch of kernel ``kid`` ("k1", "k2", "k3") at ``shape``,
    in the form its launcher reported, and, while the tracer records, the
    host nanoseconds since ``t0`` (``profiling.clock_ns()``)."""
    profiling.count(f"{kid}.launches")
    profiling.count(f"{kid}.launch_shapes", key=shape)
    if form is not None:
        profiling.count(FORM_COUNTERS[kid][form])
    profiling.count(f"{kid}.host_ns", profiling.clock_ns() - t0)
    profiling.count(f"{kid}.traced_launches")


def group_stats_reference(x: torch.Tensor, num_groups: int,
                          eps: float = 1e-6) -> torch.Tensor:
    """(B, G, 2) fp32 [mean, rstd] of x (B, C, L) per (batch row, group),
    with the biased variance."""
    xf = x.float().reshape(x.shape[0], num_groups, -1)
    mean = xf.mean(dim=-1)
    var = (xf - mean[..., None]).square().mean(dim=-1)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=-1)


def _normalized(x: torch.Tensor, stats: torch.Tensor, num_groups: int) -> torch.Tensor:
    """xhat = (x - mean) * rstd in fp32, (B, C, L)."""
    b, c, l = x.shape
    xf = x.float().reshape(b, num_groups, -1)
    return ((xf - stats[..., :1]) * stats[..., 1:]).reshape(b, c, l)


def group_norm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, num_groups: int,
                              eps: float = 1e-6,
                              apply_silu: bool = True) -> torch.Tensor:
    """Plain PyTorch GroupNorm (+SiLU): x (B, C, L); scale, bias (C,)."""
    y = _normalized(x, group_stats_reference(x, num_groups, eps), num_groups)
    y = y * scale.float()[:, None] + bias.float()[:, None]
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_silu_backward_reference(x: torch.Tensor, dy: torch.Tensor,
                                       scale: torch.Tensor, bias: torch.Tensor,
                                       stats: torch.Tensor, num_groups: int,
                                       apply_silu: bool = True):
    """Plain closed-form backward (``sleepgen/nn/fused_norm.py:81-114``):
    x, dy (B, C, L); stats (B, G, 2) [mean, rstd] of the forward. Returns
    (dx in x's dtype, dscale, dbias in fp32), all math in fp32."""
    b, c, l = x.shape
    xhat = _normalized(x, stats, num_groups)
    dz = dy.float()
    if apply_silu:
        z = xhat * scale.float()[:, None] + bias.float()[:, None]
        sig = torch.sigmoid(z)
        dz = dz * sig * (1.0 + z * (1.0 - sig))
    dscale = (dz * xhat).sum(dim=(0, 2))
    dbias = dz.sum(dim=(0, 2))
    dxhat = (dz * scale.float()[:, None]).reshape(b, num_groups, -1)
    xg = xhat.reshape(b, num_groups, -1)
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xg).mean(dim=-1, keepdim=True)
    dx = stats[..., 1:] * (dxhat - m1 - xg * m2)
    return dx.reshape(b, c, l).to(x.dtype), dscale, dbias


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


def group_norm_silu_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            num_groups: int, eps: float = 1e-6, apply_silu: bool = True):
    """(y, stats) of GroupNorm (+SiLU) without a gradient: y in x's dtype,
    stats (B, G, 2) fp32 [mean, rstd]. K1 on a CUDA tensor, the plain
    version on a CPU one."""
    t0 = profiling.clock_ns()
    if x.device.type == "cpu":
        stats = group_stats_reference(x, num_groups, eps)
        y = _normalized(x, stats, num_groups) * scale.float()[:, None] + bias.float()[:, None]
        return (F.silu(y) if apply_silu else y).to(x.dtype), stats
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_group_inputs(x, scale, bias, num_groups)
    b, c, l = x.shape
    lib = _build.load()
    y = torch.empty_like(x)
    stats = torch.empty((b, num_groups, 2), dtype=torch.float32, device=x.device)
    floats = lib.sg_group_norm_silu_scratch_floats(  # 0 unless the group streams
        x.data_ptr(), y.data_ptr(), b, c, l, num_groups, DTYPE_CODES[x.dtype])
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None
    form = ctypes.c_int(-1)
    code = lib.sg_group_norm_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), stats.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, c, l, num_groups, eps,
        int(apply_silu), DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream,
        ctypes.byref(form))
    _build.check(lib, code, "group_norm_silu")
    count_launch("k1", (b, c, l, num_groups, bool(apply_silu), str(x.dtype)), t0, form.value)
    return y, stats


def group_norm_silu_backward(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, stats: torch.Tensor, num_groups: int,
                             apply_silu: bool = True):
    """(dx, dscale, dbias) of ``group_norm_silu`` at x for the output
    gradient dy, from the forward's stats (B, G, 2). K3 on CUDA tensors,
    the plain closed form on CPU tensors."""
    t0 = profiling.clock_ns()
    if x.device.type == "cpu":
        return group_norm_silu_backward_reference(x, dy, scale, bias, stats, num_groups,
                                                  apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_group_inputs(x, scale, bias, num_groups)
    b, c, l = x.shape
    shape = (b, c, l, num_groups, bool(apply_silu), str(x.dtype))
    if not dy.is_contiguous():  # cuDNN's convolution backward may hand back strided ones
        profiling.count("k3.strided_dy_shapes", key=shape + (tuple(dy.stride()),))
        dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be a {tuple(x.shape)} {x.dtype} tensor on {x.device}, "
                         f"got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if (stats.shape != (b, num_groups, 2) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous float32 ({b}, {num_groups}, 2) "
                         f"tensor on {x.device}")
    lib = _build.load()
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    dbias = torch.empty_like(bias)
    row_sums = torch.empty(2 * b * c, dtype=torch.float32, device=x.device)
    form = ctypes.c_int(-1)
    code = lib.sg_group_norm_silu_bwd(
        x.data_ptr(), dy.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), row_sums.data_ptr(),
        b, c, l, num_groups, int(apply_silu), DTYPE_CODES[x.dtype],
        torch.cuda.current_stream().cuda_stream, ctypes.byref(form))
    _build.check(lib, code, "group_norm_silu_bwd")
    count_launch("k3", shape, t0, form.value)
    return dx, dscale, dbias


class GroupNormSiLU(torch.autograd.Function):
    """K1 forward, K3 backward (plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        y, stats = group_norm_silu_forward(x, scale, bias, num_groups, eps, apply_silu)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.num_groups, ctx.apply_silu = num_groups, apply_silu
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, stats = ctx.saved_tensors
        dx, dscale, dbias = group_norm_silu_backward(x, dy, scale, bias, stats,
                                                     ctx.num_groups, ctx.apply_silu)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dscale if need[1] else None,
                dbias if need[2] else None, None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-6,
                    apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm + per-channel affine (+SiLU) over x (B, C, L), with a
    gradient. scale and bias are (C,) fp32. Returns (B, C, L) in x's dtype."""
    return GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)


def group_norm_silu_tiled(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          num_groups: int, eps: float = 1e-6, apply_silu: bool = True,
                          tile: int = 512) -> torch.Tensor:
    """Counterpart of the Pallas ``group_norm_silu_tiled``
    (``sleepgen/pallas_kernels/group_norm.py:159``), the long-window form:
    forward only, any L. ``tile`` sets the Pallas kernel's VMEM block
    (shrunk there to a divisor of L); K1 already takes any L (a group
    above ``CLUSTER_MAX``, as the long window's, streams in 2048-element
    chunks), so the launch is K1's and the tile is only checked: a tile
    of 0 fails in JAX too."""
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return group_norm_silu_forward(x, scale, bias, num_groups, eps, apply_silu)[0]
