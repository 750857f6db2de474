"""Kernel K4 (the DiT's pass between two half-blocks) and its plain version.

At each boundary between half-blocks of ``nn/dit.py``, one row pass over
the fp32 residual stream x (B, T, D) applies the pending branch, if any,
and makes the next GEMM's input::

    x_new = x + gate[b] * h        (h (B, T, D), gate (B, D): the pending branch)
    y     = (shift[b] + LayerNorm(x_new) * (1 + scale[b])).to(dtype)

LayerNorm without affine, biased variance, eps 1e-6; the residual, the
statistics and the modulation in fp32, y in the compute dtype. h, gate,
shift and scale come in that dtype; gate, shift and scale may be chunks of
adaLN projections' (B, k D) outputs, rows of stride k D (the gate's stride
may differ from shift's and scale's: the final layer's gate is the last
block's).

``adaln_modulate_reference`` is today's composed PyTorch ops (``addcmul``,
``F.layer_norm``, ``addcmul``, ``.to``): it returns a new x_new and works
under autograd. K4 (``sleepgen_torch/csrc/adaln_modulate.cu``, whose note
gives its bound and design) does the same in one launch and writes x_new
into x in place; it replaces no TPU kernel, the JAX package having no DiT.
``adaln_modulate`` alone decides between them: the composed ops for CPU
tensors, for inputs that autograd follows (K4 has no backward) and under
autocast (whose dtypes are autocast's: training's evaluation), K4 for
every other input, and on a CUDA input that K4 does not take it raises and
never falls back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sleepgen_torch.kernels import _build
from sleepgen_torch.kernels.group_norm import DTYPE_CODES
from sleepgen_torch.utils import profiling

LN_EPS = 1e-6  # the DiT's LayerNorm; kEps in csrc/adaln_modulate.cu
MAX_D = 2048  # 32 lanes x 4 x kMaxVecs in csrc/adaln_modulate.cu
# Counters (``utils.profiling``): K4's launches; and, K4's one caller being
# the DiT's pass between half-blocks (``nn/dit.py::modulate``), the DiT's
# passes that ran K4 while the tracer records
profiling.register("k4.launches")
profiling.register("dit.fused_norms", traced=True)

Pending = Optional[Tuple[torch.Tensor, torch.Tensor]]  # (h, gate)


def adaln_modulate_reference(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                             dtype: torch.dtype,
                             pending: Pending = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_new, y) by the composed ops; x_new is x itself when nothing is
    pending, else a new tensor."""
    if pending is not None:
        h, gate = pending
        x = torch.addcmul(x, gate[:, None], h)
    n = F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)
    return x, torch.addcmul(shift[:, None], n, 1.0 + scale.float()[:, None]).to(dtype)


def _row_of_quads(t: torch.Tensor, b: int, d: int) -> bool:
    """t is (b, d) with d contiguous, rows and base on four-element bounds."""
    q = 4 * t.element_size()
    return (tuple(t.shape) == (b, d) and t.stride(1) == 1 and t.stride(0) % 4 == 0
            and t.data_ptr() % q == 0)


def _unsuitable(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                pending: Pending = None) -> Optional[str]:
    """Why K4 does not take these CUDA inputs, or None where it does: all
    on the current CUDA device, a contiguous 16-byte aligned fp32 stream
    (B, T, D) with D a multiple of 4 up to ``MAX_D``, and h, gate, shift,
    scale in the compute dtype, fp32 or bf16, laid out for 4-element
    vectors."""
    tensors = (x, shift, scale) + (() if pending is None else tuple(pending))
    if (any(t.device != x.device for t in tensors)
            or x.device.index != torch.cuda.current_device()):
        return f"inputs must all be on the current CUDA device, x is on {x.device}"
    if dtype not in DTYPE_CODES or x.dtype != torch.float32:
        return f"needs an fp32 stream and a compute dtype of fp32 or bf16, got {x.dtype}, {dtype}"
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        return "x must be a contiguous, 16-byte aligned (B, T, D) tensor"
    b, _, d = x.shape
    if d % 4 or d > MAX_D:
        return f"D {d} is not a multiple of 4 up to {MAX_D}"
    if not 0 < x.numel() < 2**31:
        return f"shape {tuple(x.shape)} is empty or too large for the kernel"
    mods = (shift, scale) if pending is None else (shift, scale, pending[1])
    if (any(t.dtype != dtype or not _row_of_quads(t, b, d) for t in mods)
            or scale.stride(0) != shift.stride(0)):
        return (f"gate, shift and scale must be ({b}, {d}) {dtype} rows, D contiguous, "
                "aligned, shift's and scale's of one stride")
    if pending is not None:
        h = pending[0]
        if (h.dtype != dtype or h.shape != x.shape or not h.is_contiguous()
                or h.data_ptr() % (4 * h.element_size())):
            return f"h must be a contiguous, aligned {tuple(x.shape)} {dtype} tensor"
    return None


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype, pending: Pending = None,
                   write_back: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(x_new, y), x_new None when ``write_back`` is False (the final
    layer's pass). The composed ops on CPU tensors, on inputs that autograd
    follows and under autocast (x_new a new tensor); K4 otherwise, which
    updates x in place and returns it as x_new, or leaves it as it is, and
    raises on an input it does not take."""
    tensors = (x, shift, scale) + (() if pending is None else tuple(pending))
    if (not x.is_cuda or torch.is_autocast_enabled(x.device.type)
            or (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))):
        x, y = adaln_modulate_reference(x, shift, scale, dtype, pending)
        return (x if write_back else None), y
    why = _unsuitable(x, shift, scale, dtype, pending)
    if why is not None:
        raise ValueError(f"adaln_modulate: {why}")
    b, t, d = x.shape
    lib = _build.load()
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    h, gate = (None, None) if pending is None else pending
    code = lib.sg_adaln_modulate(
        x.data_ptr(), x.data_ptr() if write_back and pending is not None else None,
        None if h is None else h.data_ptr(), None if gate is None else gate.data_ptr(),
        shift.data_ptr(), scale.data_ptr(), y.data_ptr(), b * t, t, d, shift.stride(0),
        0 if gate is None else gate.stride(0), DTYPE_CODES[dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "adaln_modulate")
    profiling.count("k4.launches")
    profiling.count("dit.fused_norms")
    return (x if write_back else None), y
