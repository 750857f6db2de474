"""Kernel K5 (the UNet's softmax attention in bf16) and its plain version,
and the one place that decides how an attention runs.

``attention(qkv, num_heads, mixed_precision)`` takes the qkv convolution's
output (B, 3C, L), q, k and v stacked per head along the channels, and
returns (B, C, L) in qkv's dtype: per head, q and k each scaled by d^-1/4,
softmax over the keys in fp32. It sends the input, by what the input shows:

- to ``sdpa_attention`` (one ``scaled_dot_product_attention``) on the
  strict path (``mixed_precision`` False: JAX's strict attention), where
  autograd follows the input (K5 has no backward), for a dtype other than
  bf16, and, counted as ``k5.declined``, where K5 does not take the length
  or the head dim (L past ``MAX_L``, the long window's, or not a multiple of
  8; d not a multiple of 64 up to ``MAX_D``);
- else to K5 (``fused_attention``, ``sleepgen_torch/csrc/attention.cu``,
  whose note gives its bound and design) for a CUDA tensor, and to its plain
  version (``attention_reference``) for a CPU tensor.

K5 and the plain version compute the JAX package's fast-math attention
(``sleepgen/nn/layers.py:222-239``, ``mixed_precision``): the logits of
bf16 q and k with fp32 sums, an fp32 softmax, the weights rounded to bf16,
their product with v with fp32 sums, rounded to bf16. The plain version
rounds the scaled q and k to bf16 as JAX does; K5 folds both scales into
the fp32 logits. K5 replaces no TPU kernel: the JAX package's attention is
jnp einsums. ``fused_attention`` raises on what it does not take; nothing
falls back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sleepgen_torch.kernels import _build
from sleepgen_torch.kernels.fused_resblock import needs_grad
from sleepgen_torch.utils import profiling

MAX_L = 768  # 64 x MAX_KB in csrc/attention.cu: the whole row of logits in registers
MAX_D = 512
LOG2E = math.log2(math.e)
# Counters (``utils.profiling``): K5's launches, and those made while the
# tracer records (a replayed graph's included); the fast-math bf16
# attentions without gradient that K5 does not take for their length or
# head dim, which run SDPA
profiling.register_twin("k5.launches", "k5.traced_launches")
profiling.register("k5.declined")


def k5_takes(length: int, head_dim: int) -> bool:
    """Whether K5 takes a row of ``length`` positions at ``head_dim``."""
    return 0 < length <= MAX_L and length % 8 == 0 and 0 < head_dim <= MAX_D and head_dim % 64 == 0


def route(device: str, dtype: torch.dtype, grad: bool, mixed_precision: bool,
          length: int, head_dim: int) -> str:
    """How ``attention`` runs an input: "sdpa", "declined" (SDPA, where K5
    does not take the length or head dim), "k5" (a CUDA tensor) or "plain"
    (a CPU tensor)."""
    if not mixed_precision or grad or dtype != torch.bfloat16:
        return "sdpa"
    if not k5_takes(length, head_dim):
        return "declined"
    return {"cuda": "k5", "cpu": "plain"}.get(device, "sdpa")


def _heads(qkv: torch.Tensor, num_heads: int):
    """(B, 3C, L) -> q, k, v each (B, heads, d, L), views."""
    b, c3, l = qkv.shape
    d = c3 // (3 * num_heads)
    return qkv.reshape(b, num_heads, 3 * d, l).split(d, dim=2)


def sdpa_attention(qkv: torch.Tensor, num_heads: int, mixed_precision: bool) -> torch.Tensor:
    """One ``scaled_dot_product_attention`` on transposed views, its own scale
    set to 1. ``mixed_precision``: the scaled q and k cast back to qkv's
    dtype and the products run there. Without it (JAX's strict path) q, k and
    v enter the product in fp32, outside autocast, and the result is cast to
    qkv's dtype; JAX also rounds the softmax weights to the compute dtype
    before their product with v, which this path does not. In fp32 the two
    are the same computation."""
    b, c3, l = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[2]))
    q, k, v = (t.transpose(-1, -2) for t in (q, k, v))  # (B, h, L, d)
    if mixed_precision:
        out = F.scaled_dot_product_attention((q.float() * scale).to(qkv.dtype),
                                             (k.float() * scale).to(qkv.dtype), v, scale=1.0)
    else:
        with torch.autocast(qkv.device.type, enabled=False):
            out = F.scaled_dot_product_attention(q.float() * scale, k.float() * scale,
                                                 v.float(), scale=1.0).to(qkv.dtype)
    return out.transpose(-1, -2).reshape(b, c3 // 3, l)


def attention_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of K5, the JAX package's fast-math roundings: q and k
    scaled in fp32 and rounded to qkv's dtype, logits in fp32, softmax in
    fp32, the weights rounded to qkv's dtype, their product with v summed in
    fp32 and rounded to qkv's dtype."""
    b, c3, l = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[2]))
    q, k = ((t.float() * scale).to(qkv.dtype) for t in (q, k))
    logits = torch.einsum("bhci,bhcj->bhij", q.float(), k.float())
    weights = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhij,bhcj->bhci", weights.float(), v.float())
    return out.to(qkv.dtype).reshape(b, c3 // 3, l)


def _unsuitable(qkv: torch.Tensor, num_heads: int) -> str | None:
    """Why K5 does not take this CUDA input, or None where it does."""
    if qkv.device.type != "cuda" or qkv.device.index != torch.cuda.current_device():
        return f"qkv must be on the current CUDA device, it is on {qkv.device}"
    if needs_grad(qkv):
        return ("K5 has no backward: call it under torch.no_grad() or inference_mode, "
                "or take sdpa_attention")
    if qkv.dtype != torch.bfloat16:
        return f"needs bf16, got {qkv.dtype}"
    if qkv.dim() != 3 or num_heads <= 0 or qkv.shape[1] % (3 * num_heads):
        return f"qkv {tuple(qkv.shape)} is not (B, 3 heads d, L) for {num_heads} heads"
    b, c3, l = qkv.shape
    d = c3 // (3 * num_heads)
    if not k5_takes(l, d):
        return (f"L {l} (a multiple of 8 up to {MAX_L}) or head dim {d} (a multiple of 64 "
                f"up to {MAX_D}) out of range")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        return "qkv must be contiguous and 16-byte aligned"
    if not 0 < b * num_heads <= 65535:
        return f"batch x heads {b * num_heads} beyond the kernel's grid (65535)"
    return None


def fused_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K5: the attention of qkv (B, 3C, L) bf16 -> (B, C, L) bf16 in one
    launch on the current stream; raises on an input it does not take
    (``_unsuitable``)."""
    why = _unsuitable(qkv, num_heads)
    if why is not None:
        raise ValueError(f"fused_attention: {why}")
    b, c3, l = qkv.shape
    d = c3 // (3 * num_heads)
    lib = _build.load()
    out = torch.empty((b, c3 // 3, l), dtype=qkv.dtype, device=qkv.device)
    code = lib.sg_attention(qkv.data_ptr(), out.data_ptr(), b, num_heads, d, l,
                            LOG2E / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "fused_attention")
    profiling.count("k5.launches")
    return out


def attention(qkv: torch.Tensor, num_heads: int, mixed_precision: bool = True) -> torch.Tensor:
    """Softmax attention over the length axis: qkv (B, 3C, L), q, k and v
    stacked per head along the channels -> (B, C, L) in qkv's dtype; per
    head q and k scaled by d^-1/4 in fp32 and the softmax in fp32.
    ``mixed_precision`` is the JAX package's ``fast_math`` attention
    (``sleepgen/nn/layers.py:221-238``), the products in the compute dtype;
    without it (JAX's strict path) q, k and v enter the product in fp32. Run
    as ``route`` decides; ``nn/layers.py`` takes it from here."""
    _, c3, l = qkv.shape
    way = route(qkv.device.type, qkv.dtype, needs_grad(qkv), mixed_precision, l,
                c3 // (3 * num_heads))
    if way == "k5":
        return fused_attention(qkv, num_heads)
    if way == "plain":
        return attention_reference(qkv, num_heads)
    if way == "declined":
        profiling.count("k5.declined")
    return sdpa_attention(qkv, num_heads, mixed_precision)
