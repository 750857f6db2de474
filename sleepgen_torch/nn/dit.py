"""Diffusion Transformer (DiT, Peebles and Xie 2023, arXiv:2212.09748) over
the 1-D EEG latent, in torch's (B, C, L) layout at its input and output.

The published model (``facebookresearch/DiT``, ``models.py``; DiT-XL/2 is
depth 28, hidden 1152, 16 heads, MLP ratio 4, patch 2) as a stage-2
denoiser beside ``UNet1d``: ``c = t_emb + y_emb``; per block, ``SiLU(c) ->
Linear(D, 6 D)`` gives shift, scale and gate for the attention and the
MLP, ``x += gate_msa * Attn(LN(x) * (1 + scale_msa) + shift_msa)`` and
``x += gate_mlp * MLP(LN(x) * (1 + scale_mlp) + shift_mlp)``, LayerNorm
without affine at eps 1e-6, attention with a biased qkv projection and
scale d^-1/2, the MLP D -> 4 D -> D with tanh GELU; the final layer is
adaLN shift and scale, LayerNorm, ``Linear(D, patch * C)``. Parameters
carry the published names (``x_embedder.proj``, ``t_embedder.mlp.0``,
``y_embedder.embedding_table``, ``blocks.N.attn.qkv``,
``blocks.N.adaLN_modulation.1``, ``final_layer.linear``, ...).

Departures from the published model:

* Patches and positions are 1-D: ``Conv1d(C, D, patch, stride patch)``
  and the published 1-D sin-cos table ([sin | cos] over the token index),
  a buffer that is not in the state dict (the published table is a frozen
  parameter).
* No learned variance (``learn_sigma`` False): the output has C channels,
  the single prediction the port's loops take.
* Labels: ``y`` (B,) with a label < 0 the classifier-free-guidance null
  label, which selects the table's last row, as ``UNet1d`` takes -1; no
  ``y`` is the null label for every row. Label dropout is the trainer's
  (``train.cond_dropout_prob``), not the embedder's.

Precision: under ``cast_compute_dtype`` (sampling) the linear layers run
in the weights' dtype; under autocast (training) in autocast's. The
residual stream, LayerNorm and the modulation and gating are fp32 in
either case; the attention gets (B, heads, T, d) q, k and v in the compute
dtype with the head dimension contiguous, so ``scaled_dot_product_attention``
takes a fused kernel (on an H100, cuDNN's flash attention). The output is
fp32, as ``UNet1d``'s.

The pass between half-blocks (``modulate``): a half returns its branch's
output h and its gate instead of adding them, and that pending pair is
applied by the next half's pass, the last block's by the final layer's.
One pass per half, 2 depth + 1 a forward, computes ``x_new = x + gate *
h`` (no pending pair before block 0's attention), LayerNorm of x_new, the
modulation by shift and scale and the cast to the compute dtype. It has two
implementations (``kernels/adaln.py``) with the same mathematics and
precisions, and ``adaln.adaln_modulate`` alone chooses between them:

* K4, one hand-written launch that writes x_new into the stream in place
  (not at all for the final layer, which needs only the GEMM input), on
  CUDA tensors that autograd does not follow outside autocast (the
  samplers' ``inference_mode``, ``torch.no_grad``, or a model whose
  parameters need no gradient); it takes a contiguous fp32 stream, a
  compute dtype of bf16 or fp32 and a width D that is a multiple of 4 up to
  2048, and raises on any other CUDA input, so a strided stream or an fp16
  model fails loudly instead of running the composed ops;
* the composed ops (``addcmul``, ``F.layer_norm``, ``addcmul``, ``.to``)
  on the CPU, under autograd, so training's gradients are those of the
  ops, and under autocast (training's evaluation).

The choice rests only on what the pass sees in its inputs and modes.

Tracing (``utils.profiling``): a forward is a ``dit.forward`` span over
``dit.cond`` (the embedders and every block's adaLN projection), per block
``dit.attn`` and ``dit.mlp``, each holding its ``dit.modulate`` (the
pass: the previous half's gated residual, LayerNorm, modulation and cast),
and ``dit.final`` with the last ``dit.modulate``. While the tracer records,
``dit.forwards`` counts forwards, ``dit.tokens`` their rows times tokens
and ``dit.fused_norms`` (counted by K4's wrapper) the passes that ran K4
(``profiling.counters()``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.kernels import adaln
from sleepgen_torch.nn.layers import timestep_embedding
from sleepgen_torch.nn.moe import SparseMoeBlock
from sleepgen_torch.utils import profiling
from sleepgen_torch.utils.profiling import span

FREQUENCY_EMBEDDING_SIZE = 256  # the published TimestepEmbedder's
# Forwards and their rows x tokens while the tracer records
profiling.register("dit.forwards", "dit.tokens", traced=True)


def sincos_positions(dim: int, length: int) -> torch.Tensor:
    """(length, dim) fp32: the published ``get_1d_sincos_pos_embed_from_grid``
    of positions 0..length-1, [sin | cos] at frequencies 10000^(-i / (dim/2))."""
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0))
    out = torch.arange(length, dtype=torch.float64)[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1).float()


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
             pending: adaln.Pending = None, write_back: bool = True):
    """The pass between half-blocks: (x_new, y) for the fp32 stream x (B, T,
    D), shift and scale (B, D) and the pending branch (h, gate), if any:
    x_new = x + gate * h, y = LayerNorm(x_new) (no affine, eps 1e-6) times 1
    + scale plus shift, in fp32, cast to ``dtype``; x_new None with
    ``write_back`` False (``adaln.adaln_modulate``, which runs K4 or the
    composed ops)."""
    with span("dit.modulate"):
        return adaln.adaln_modulate(x, shift, scale, dtype, pending, write_back)


def unpatchify(tokens: torch.Tensor, patch: int, channels: int) -> torch.Tensor:
    """(B, T, patch * C) tokens, each holding its patch's positions in turn
    and each position's channels last -> (B, C, T * patch)."""
    b, n, _ = tokens.shape
    return tokens.reshape(b, n, patch, channels).permute(0, 3, 1, 2).reshape(b, channels,
                                                                             n * patch)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, hidden: int, patch: int):
        super().__init__()
        self.proj = nn.Conv1d(in_channels, hidden, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, L) -> (B, L / patch, D), contiguous: the residual stream
        takes this layout, and every LayerNorm and gated add after it reads
        D contiguous."""
        return self.proj(x).transpose(1, 2).contiguous()


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQUENCY_EMBEDDING_SIZE, hidden), nn.SiLU(),
                                 nn.Linear(hidden, hidden))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        dtype = self.mlp[0].weight.dtype
        return self.mlp(timestep_embedding(t, FREQUENCY_EMBEDDING_SIZE).to(dtype))


class LabelEmbedder(nn.Module):
    """``num_classes`` rows and the null class's last."""

    def __init__(self, num_classes: int, hidden: int):
        super().__init__()
        self.num_classes = num_classes
        self.embedding_table = nn.Embedding(num_classes + 1, hidden)

    def forward(self, y: Optional[torch.Tensor], batch: int) -> torch.Tensor:
        labels = torch.full((batch,), self.num_classes, dtype=torch.int64,
                            device=self.embedding_table.weight.device)
        if y is not None:
            labels = torch.where(y < 0, labels, y)
        return self.embedding_table(labels)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden size {hidden} not divisible by {heads} heads")
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """q, k and v go to SDPA as (B, h, T, d) views of the qkv GEMM's
        output, d contiguous, which the fused kernels take without a copy;
        SDPA returns its output in that (B, T, h, d) layout, which ``proj``
        reads as it is."""
        b, t, d = x.shape
        q, k, v = (u.transpose(1, 2) for u in
                   self.qkv(x).view(b, t, 3, self.heads, d // self.heads).unbind(2))
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, t, d))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_hidden)
        self.fc2 = nn.Linear(mlp_hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """Attention and MLP halves with adaLN-Zero; with ``num_experts`` > 0 the
    MLP is DiT-MoE's ``moe`` (``nn/moe.py``: top ``num_experts_per_tok``
    routed SwiGLU experts and ``n_shared_experts`` shared ones), else the
    dense ``mlp``."""

    def __init__(self, hidden: int, heads: int, mlp_ratio: float, num_experts: int = 0,
                 num_experts_per_tok: int = 2, n_shared_experts: int = 0,
                 aux_loss_alpha: float = 0.01):
        super().__init__()
        self.attn = Attention(hidden, heads)
        if num_experts:
            self.moe = SparseMoeBlock(hidden, mlp_ratio, num_experts, num_experts_per_tok,
                                      n_shared_experts, aux_loss_alpha)
        else:
            self.mlp = Mlp(hidden, int(hidden * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 6 * hidden))

    def forward(self, x: torch.Tensor, mod: Sequence[torch.Tensor],
                pending: adaln.Pending = None):
        """x (B, T, D) fp32 without the previous half's branch, which is
        ``pending`` (h, gate), or None before the first block; ``mod``: this
        block's six (B, D) modulations. Returns the stream with every half
        before this block's MLP added, and the MLP's (h, gate), h in the
        compute dtype whether the MLP is dense or sparse."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod
        dtype = self.attn.qkv.weight.dtype
        with span("dit.attn"):
            x, y = modulate(x, shift_msa, scale_msa, dtype, pending)
            pending = (self.attn(y), gate_msa)
        with span("dit.mlp"):
            x, y = modulate(x, shift_mlp, scale_mlp, dtype, pending)
            return x, (self.moe(y) if hasattr(self, "moe") else self.mlp(y), gate_mlp)


class FinalLayer(nn.Module):
    def __init__(self, hidden: int, patch: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden, patch * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 2 * hidden))

    def forward(self, x: torch.Tensor, mod: Sequence[torch.Tensor],
                pending: adaln.Pending = None) -> torch.Tensor:
        """The last block's MLP branch ``pending`` is added for the
        LayerNorm alone: the stream is not written back."""
        shift, scale = mod
        _, y = modulate(x, shift, scale, self.linear.weight.dtype, pending, write_back=False)
        return self.linear(y)


class DiT1d(nn.Module):
    """(B, in_channels, L) noisy latent, (B,) timesteps and optional (B,)
    labels (< 0: the null label) -> (B, in_channels, L) fp32, L being
    ``input_size``. ``num_classes`` 0 builds no label embedder and ignores
    ``y``. ``num_experts`` > 0 builds DiT-MoE (Fei et al. 2024,
    arXiv:2407.11633; DiT-MoE-XL/2-8E2A is DiT-XL/2 with 8 experts, top 2
    and 2 shared): every block's MLP a sparse mixture of SwiGLU experts
    (``nn/moe.py``); a training forward then leaves the sum of the blocks'
    auxiliary losses in ``aux_loss`` (else None), which the trainer adds to
    the diffusion loss."""

    def __init__(self, in_channels: int = 1, input_size: int = 768, patch_size: int = 2,
                 hidden_size: int = 1152, depth: int = 28, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_classes: int = 0, num_experts: int = 0,
                 num_experts_per_tok: int = 2, n_shared_experts: int = 0,
                 aux_loss_alpha: float = 0.01):
        super().__init__()
        if input_size % patch_size:
            raise ValueError(f"input size {input_size} not divisible by patch {patch_size}")
        self.patch_size, self.num_classes = patch_size, num_classes
        self.num_experts = num_experts
        self.aux_loss: Optional[torch.Tensor] = None
        self.x_embedder = PatchEmbed(in_channels, hidden_size, patch_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        if num_classes:
            self.y_embedder = LabelEmbedder(num_classes, hidden_size)
        self.register_buffer("pos_embed",
                             sincos_positions(hidden_size, input_size // patch_size),
                             persistent=False)
        self.blocks = nn.ModuleList([DiTBlock(hidden_size, num_heads, mlp_ratio, num_experts,
                                              num_experts_per_tok, n_shared_experts,
                                              aux_loss_alpha) for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, patch_size, in_channels)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("dit.forward"):
            b, c, length = x.shape
            n = length // self.patch_size
            if length % self.patch_size or n != self.pos_embed.shape[0]:
                raise ValueError(f"length {length} is not the DiT's input size "
                                 f"{self.pos_embed.shape[0] * self.patch_size}")
            profiling.count("dit.forwards")
            profiling.count("dit.tokens", b * n)
            dtype = self.x_embedder.proj.weight.dtype
            h = self.x_embedder(x.to(dtype)).float() + self.pos_embed
            with span("dit.cond"):
                cond = self.t_embedder(timesteps)
                if self.num_classes:
                    cond = cond + self.y_embedder(y, b)
                cond = F.silu(cond)
                mods = [blk.adaLN_modulation[1](cond).chunk(6, dim=1) for blk in self.blocks]
                final_mod = self.final_layer.adaLN_modulation[1](cond).chunk(2, dim=1)
            pending = None
            for blk, mod in zip(self.blocks, mods):
                h, pending = blk(h, mod, pending)
            if self.num_experts:
                aux = [blk.moe.aux_loss for blk in self.blocks if blk.moe.aux_loss is not None]
                self.aux_loss = torch.stack(aux).sum() if aux else None
            with span("dit.final"):
                out = self.final_layer(h, final_mod, pending)  # (B, T, patch * C)
            return unpatchify(out.float(), self.patch_size, c)


def init_state(model: DiT1d, seed: int) -> Dict[str, np.ndarray]:
    """The published initialisation (``DiT.initialize_weights``), drawn with
    numpy from ``seed`` in state-dict order, as numpy arrays by name: every
    linear layer's weight Xavier-uniform and its bias zero, the patch
    embedding's weight Xavier-uniform over (D, C patch) and its bias zero,
    the label table and the timestep MLP's weights N(0, 0.02^2), and zero
    for every adaLN modulation and for the final layer's linear; DiT-MoE's
    experts are linear layers, Xavier-uniform by their published names,
    and its router U(-1/sqrt(D), 1/sqrt(D)) (``MoEGate.reset_parameters``'
    Kaiming-uniform at a = sqrt(5))."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.startswith("final_layer.") or ".adaLN_modulation." in name \
                or name.endswith("bias"):
            v = np.zeros(shape)
        elif name == "y_embedder.embedding_table.weight" or name.startswith("t_embedder."):
            v = rng.normal(0.0, 0.02, shape)
        elif name.endswith(".moe.gate.weight"):
            bound = 1.0 / math.sqrt(shape[1])
            v = rng.uniform(-bound, bound, shape)
        else:
            fan_out, fan_in = shape[0], int(np.prod(shape[1:]))
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            v = rng.uniform(-bound, bound, shape)
        out[name] = v.astype(np.float32)
    return out
