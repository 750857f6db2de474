"""Plain PyTorch reference of the Diffusion Transformer (Peebles and Xie
2023, arXiv:2212.09748; ``facebookresearch/DiT``, ``models.py``) as the
benchmark's DiT-XL/2 configuration builds it over the 1-D EEG latent.

Written from the published layer equations:
``c = t_emb + y_emb``, ``t_emb`` = MLP(256 -> D, SiLU, D -> D) of the
[cos | sin] frequency embedding, ``y_emb`` a table of ``num_classes + 1``
rows whose last is the guidance null class; per block ``SiLU(c) ->
Linear(D, 6 D)`` gives shift, scale and gate of the attention and the
MLP, ``x += gate_msa * Attn(LN(x) (1 + scale_msa) + shift_msa)``, ``x +=
gate_mlp * MLP(LN(x) (1 + scale_mlp) + shift_mlp)``; LayerNorm without
affine, eps 1e-6; attention with a biased qkv projection, softmax of
``q k^T d^-1/2``; the MLP D -> 4 D -> D with GELU's tanh form; the final
layer adaLN shift and scale, LayerNorm and ``Linear(D, patch * C)``,
unpatchified with the channels last in each token's vector. Parameter
names are the published ones (``blocks.3.adaLN_modulation.1.weight``), so
one state dict loads here and into the program under test.

Departures from the published model, as the configuration states them:
1-D patches (a Conv1d of kernel and stride ``patch``) and a 1-D sin-cos
position table ([sin | cos] of the token index), computed here and held
in no state dict; no learned variance (C output channels); labels are the
published ones, 0..num_classes-1, and ``num_classes`` is the null class.
Guidance (``guided``) is ``v_n + s (v_c - v_n)`` on the whole output, in
one forward of the 2B batch.

Float32 throughout, no fused kernels; ``models.Precision`` rounds the
operands of every product (the linear layers, the patch convolution and
both attention products). Two switches plant a fault for the checks'
calibration: ``skip_block`` (one block's update left out) and
``attention_scale`` False (softmax of q k^T without d^-1/2).

Nothing here imports the program under test or the JAX package.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from .models import Conv, Linear, Precision, timestep_embedding

FREQUENCY_EMBEDDING_SIZE = 256
LN_EPS = 1e-6


def positions(dim: int, length: int) -> torch.Tensor:
    """(length, dim): [sin | cos] of position p at frequencies
    10000^(-i / (dim / 2)), i < dim / 2, in float64 cast to float32."""
    i = torch.arange(dim // 2, dtype=torch.float64)
    omega = 1.0 / 10000.0 ** (i / (dim / 2.0))
    arg = torch.arange(length, dtype=torch.float64)[:, None] * omega[None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1).float()


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS)


def modulate(x, shift, scale):
    return layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Table(nn.Module):
    def __init__(self, rows: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(rows, dim))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, prec: Precision, scaled: bool):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, prec)
        self.proj = Linear(dim, dim, prec)
        self.heads, self.prec, self.scaled = heads, prec, scaled

    def forward(self, x):
        b, t, dim = x.shape
        d = dim // self.heads
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        s = d ** -0.5 if self.scaled else 1.0
        w = (self.prec(q) @ self.prec(k).transpose(-1, -2) * s).softmax(dim=-1)
        out = self.prec(w) @ self.prec(v)  # (B, h, T, d)
        return self.proj(out.transpose(1, 2).reshape(b, t, dim))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, prec: Precision, scaled: bool):
        super().__init__()
        self.attn = Attention(dim, heads, prec, scaled)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.ModuleDict({"fc1": Linear(dim, hidden, prec),
                                  "fc2": Linear(hidden, dim, prec)})
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(dim, 6 * dim, prec)})

    def forward(self, x, c_act):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_modulation["1"](c_act).chunk(6, dim=1)
        x = x + gate_msa[:, None] * self.attn(modulate(x, shift_msa, scale_msa))
        h = gelu_tanh(self.mlp["fc1"](modulate(x, shift_mlp, scale_mlp)))
        return x + gate_mlp[:, None] * self.mlp["fc2"](h)


class DiT(nn.Module):
    """(B, C, L) noisy latent, (B,) timesteps and (B,) labels in
    0..num_classes (the last the null class; None: the null class for every
    row) -> (B, C, L) prediction."""

    def __init__(self, in_channels: int = 1, input_size: int = 768, patch_size: int = 2,
                 hidden_size: int = 1152, depth: int = 28, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_classes: int = 5, prec: Precision | None = None,
                 skip_block: Optional[int] = None, attention_scale: bool = True):
        super().__init__()
        prec = prec or Precision()
        dim, self.patch, self.num_classes = hidden_size, patch_size, num_classes
        self.skip_block = skip_block
        self.x_embedder = nn.ModuleDict({"proj": Conv(in_channels, dim, patch_size, prec,
                                                      stride=patch_size, padding=0)})
        self.t_embedder = nn.ModuleDict({"mlp": nn.ModuleDict({
            "0": Linear(FREQUENCY_EMBEDDING_SIZE, dim, prec), "2": Linear(dim, dim, prec)})})
        self.y_embedder = nn.ModuleDict({"embedding_table": Table(num_classes + 1, dim)})
        self.blocks = nn.ModuleList([Block(dim, num_heads, mlp_ratio, prec, attention_scale)
                                     for _ in range(depth)])
        self.final_layer = nn.ModuleDict({
            "linear": Linear(dim, patch_size * in_channels, prec),
            "adaLN_modulation": nn.ModuleDict({"1": Linear(dim, 2 * dim, prec)})})

    def forward(self, x, t, y=None):
        b, c, length = x.shape
        n = length // self.patch
        h = self.x_embedder["proj"](x).transpose(1, 2)
        h = h + positions(h.shape[-1], n).to(h.device)
        mlp = self.t_embedder["mlp"]
        cond = mlp["2"](silu(mlp["0"](timestep_embedding(t, FREQUENCY_EMBEDDING_SIZE))))
        if y is None:
            y = torch.full((b,), self.num_classes, dtype=torch.int64, device=x.device)
        c_act = silu(cond + self.y_embedder["embedding_table"].weight[y])
        for i, block in enumerate(self.blocks):
            if i != self.skip_block:
                h = block(h, c_act)
        fin = self.final_layer
        shift, scale = fin["adaLN_modulation"]["1"](c_act).chunk(2, dim=1)
        out = fin["linear"](modulate(h, shift, scale))  # (B, T, patch * C)
        return out.reshape(b, n, self.patch, c).permute(0, 3, 1, 2).reshape(b, c, length)


def guided(dit: DiT, labels: torch.Tensor, scale: float) -> Callable:
    """``model(x, t)``: classifier-free guidance of ``dit`` at ``scale``, the
    conditional and the null branch in one forward of the 2B batch."""
    null = torch.full_like(labels, dit.num_classes)
    y2 = torch.cat([labels, null])

    def model(x, t):
        v_c, v_n = dit(torch.cat([x, x]), torch.cat([t, t]), y2).chunk(2)
        return v_n + scale * (v_c - v_n)

    return model


def conditional(dit: DiT, labels: torch.Tensor) -> Callable:
    """``model(x, t)``: ``dit`` on ``labels`` alone (guidance off)."""
    return lambda x, t: dit(x, t, labels)
