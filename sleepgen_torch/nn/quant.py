"""Int8 quantized sampling: convolutions as int8 x int8 -> int32 products.

Counterpart of ``sleepgen/nn/quant.py``, in torch's (B, C, L) layout:

  * weights: symmetric per-output-channel int8, scale = amax / 127,
    converted offline from trained fp32 weights (``quantize_unet_params``);
  * activations: symmetric per-tensor int8, the scale computed from the
    live tensor on the device (``act_quantize``: no value is read back);
  * a k-tap convolution becomes one product on the (B L, k C_in) im2col
    stack, accumulated in int32 (``torch._int_mm``) and dequantized once.

GroupNorm statistics, the softmax and the scheduler math stay fp32, as in
the JAX package. Sampling only: nothing here has a gradient.

``torch._int_mm`` on a CUDA tensor takes only an M above 16 and a K and N
that are multiples of 8; the UNet's ``conv_in`` on a one-channel latent
has k C_in = 3 and its ``conv_out`` C_out = 1. The im2col stack and the
weight matrix are padded with zeros to those sizes, which leaves every
int32 sum exact, and the padding is cut from the product. The same padded
product runs on the CPU.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def quantize_kernel_per_cout(w: np.ndarray) -> Dict[str, np.ndarray]:
    """fp32 conv weight (C_out, C_in, k) -> ``weight_q`` int8 of the same
    shape and ``weight_scale`` (C_out,) fp32, as the JAX package's
    ``quantize_kernel_per_cout`` does it in its (k, C_in, C_out) layout."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(1, w.ndim)))  # (C_out,)
    scale = np.maximum(amax, 1e-12) / 127.0
    shaped = scale.reshape((-1,) + (1,) * (w.ndim - 1))
    wq = np.clip(np.round(w / shaped), -127, 127).astype(np.int8)
    return {"weight_q": wq, "weight_scale": scale.astype(np.float32)}


def act_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor int8 quantization of x: (int8 x, 0-d
    fp32 scale), both on x's device."""
    xf = x.float()
    a_scale = torch.clamp(xf.abs().amax(), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / a_scale), -127.0, 127.0).to(torch.int8)
    return xq, a_scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """int8 weight (C_out, C_in, k) -> the (k C_in, C_out) matrix of the
    im2col product (row d C_in + c is tap d of input channel c), zero
    padded to multiples of 8 in both dimensions."""
    c_out, c_in, k = wq.shape
    mat = wq.permute(2, 1, 0).reshape(k * c_in, c_out)
    return F.pad(mat, (0, _round_up(c_out, 8) - c_out, 0, _round_up(k * c_in, 8) - k * c_in))


def int8_conv_accumulate(xq: torch.Tensor, w_mat: torch.Tensor, kernel: int,
                         c_out: int) -> torch.Tensor:
    """The int32 accumulators (B, L, C_out) of a stride-1 SAME convolution
    of int8 x (B, C_in, L) with the padded int8 ``weight_matrix`` of a
    ``kernel``-tap weight: zero pad, stack the taps along the channels, one
    ``torch._int_mm``."""
    b, c_in, l = xq.shape
    pad = kernel // 2
    if kernel > 1:
        cols = F.pad(xq, (pad, pad)).unfold(2, kernel, 1)  # (B, C_in, L, k)
        cols = cols.permute(0, 2, 3, 1).reshape(b * l, kernel * c_in)
    else:
        cols = xq.transpose(1, 2).reshape(b * l, c_in)
    m = b * l
    if cols.shape[1] != w_mat.shape[0] or m < 17:
        cols = F.pad(cols, (0, w_mat.shape[0] - cols.shape[1], 0, max(17 - m, 0)))
    acc = torch._int_mm(cols.contiguous(), w_mat)
    return acc[:m, :c_out].reshape(b, l, c_out)


class QuantConv1d(nn.Module):
    """Drop-in int8 replacement for ``layers.conv1d`` (stride 1, SAME
    padding) on (B, C, L). Buffers, made by ``quantize_unet_params`` and
    never trained: ``weight_q`` int8 (C_out, C_in, k), ``weight_scale``
    (C_out,) fp32, ``bias`` (C_out,) fp32. The output has x's dtype (the
    model's compute dtype, which x already has)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__()
        self.kernel, self.out_channels = kernel, out_channels
        self.register_buffer("weight_q", torch.zeros((out_channels, in_channels, kernel),
                                                     dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_channels))
        self.register_buffer("bias", torch.zeros(out_channels))
        self._mat = None  # ((weight_q's storage, version), its weight_matrix)

    def matrix(self) -> torch.Tensor:
        w = self.weight_q
        if w.is_inference():  # no version counter: laid out on every call
            return weight_matrix(w)
        key = (w.data_ptr(), w._version)
        if self._mat is None or self._mat[0] != key:
            self._mat = (key, weight_matrix(w))
        return self._mat[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, a_scale = act_quantize(x)
        acc = int8_conv_accumulate(xq, self.matrix(), self.kernel, self.out_channels)
        y = acc.float() * (a_scale * self.weight_scale) + self.bias
        return y.transpose(1, 2).to(x.dtype)


def quantize_unet_params(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The port's fp32 ``UNet1d`` state dict -> the state dict of
    ``UNet1d(quantized=True)``: every convolution weight (3-D) becomes
    ``weight_q`` and ``weight_scale`` beside its fp32 bias; linear layers,
    GroupNorms and the label embedding pass unchanged."""
    out: Dict[str, np.ndarray] = {}
    for name, v in state.items():
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        if name.endswith(".weight") and v.ndim == 3:
            prefix = name[: -len("weight")]
            for k, q in quantize_kernel_per_cout(v).items():
                out[prefix + k] = q
        else:
            out[name] = v
    return out
