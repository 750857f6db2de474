"""Plain PyTorch reference of DiT-MoE (Fei et al. 2024, "Scaling Diffusion
Transformers to 16 Billion Parameters", arXiv:2407.11633;
``feizc/DiT-MoE``, ``models.py``) as the benchmark's DiT-MoE-XL/2-8E2A
configuration builds it over the 1-D EEG latent: the DiT of ``dit.py``
(imported, not copied) with every block's MLP a sparse mixture of experts.

Written from the published layer equations. Per block, the MLP half is
``x += gate_mlp * MoE(u)``, ``u = LN(x) (1 + scale_mlp) + shift_mlp``:

* the gate: ``p = softmax(W_g u)``, ``W_g`` (E, D) without bias; the top k
  of E kept with their probabilities as weights, not renormalised;
* each routed expert a SwiGLU without biases, ``W_down (SiLU(W_gate u) *
  W_up u)`` of intermediate width ``mlp_ratio`` D, applied to the tokens
  routed to it alone, in a Python loop over the experts (no sort, no
  grouped GEMM), each output scaled by its probability and added to its
  token's sum;
* the ``n_shared_experts`` shared experts, one SwiGLU of intermediate
  width ``n_shared_experts`` D, added on every token;
* in training mode, the gate's auxiliary loss ``alpha * sum_e P_e f_e``
  (``P_e`` the mean probability of e, ``f_e`` E times the share of routed
  slots that went to e; ``seq_aux`` False), summed over the blocks into
  ``aux_loss``.

Parameter names are the published ones (``blocks.3.moe.gate.weight``,
``blocks.3.moe.experts.5.up_proj.weight``,
``blocks.3.moe.shared_experts.down_proj.weight``).

Float32, ``models.Precision`` rounding the operands of every product, the
router's included (``Precision("fp8")`` is the control). Four switches
plant a fault of the sparse layer for the checks' calibration: ``top_k``
1 (the second expert dropped), ``renormalise`` (the top-k weights made to
sum to 1), ``no_shared`` (the shared experts left out) and
``expert_shift`` (each slot sent to expert (e + 1) mod E); ``dit.py``'s
``skip_block`` and ``attention_scale`` act as they do there.

Nothing here imports the program under test or the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import dit
from .models import Linear, Precision


class Proj(nn.Module):
    """A linear map without bias: weight (C_out, C_in)."""

    def __init__(self, cin: int, cout: int, prec: Precision):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.prec = prec

    def forward(self, x):
        return F.linear(self.prec(x), self.prec(self.weight))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, prec: Precision):
        super().__init__()
        self.gate_proj = Proj(dim, hidden, prec)
        self.up_proj = Proj(dim, hidden, prec)
        self.down_proj = Proj(hidden, dim, prec)

    def forward(self, x):
        return self.down_proj(dit.silu(self.gate_proj(x)) * self.up_proj(x))


class MoE(nn.Module):
    """(B, T, D) -> (B, T, D): routed experts, gate, shared experts."""

    def __init__(self, dim: int, mlp_ratio: float, num_experts: int, top_k: int,
                 n_shared: int, aux_loss_alpha: float, prec: Precision,
                 renormalise: bool = False, no_shared: bool = False, expert_shift: bool = False):
        super().__init__()
        self.experts = nn.ModuleList([SwiGLU(dim, int(dim * mlp_ratio), prec)
                                      for _ in range(num_experts)])
        self.gate = dit.Table(num_experts, dim)
        if n_shared:
            self.shared_experts = SwiGLU(dim, dim * n_shared, prec)
        self.top_k, self.n_shared, self.alpha, self.prec = top_k, n_shared, aux_loss_alpha, prec
        self.renormalise, self.no_shared, self.expert_shift = renormalise, no_shared, expert_shift
        self.aux_loss = None

    def forward(self, x):
        b, t, d = x.shape
        u = x.reshape(b * t, d)
        e_count = len(self.experts)
        scores = (self.prec(u) @ self.prec(self.gate.weight).t()).softmax(dim=-1)
        weight, idx = torch.topk(scores, self.top_k, dim=-1)
        if self.renormalise:
            weight = weight / weight.sum(dim=-1, keepdim=True)
        if self.expert_shift:
            idx = (idx + 1) % e_count
        out = torch.zeros_like(u)
        for e, expert in enumerate(self.experts):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if len(tok):
                out = out.index_add(0, tok, weight[tok, slot, None] * expert(u[tok]))
        if self.n_shared and not self.no_shared:
            out = out + self.shared_experts(u)
        self.aux_loss = None
        if self.training and self.alpha > 0:
            share = torch.stack([(idx == e).sum() for e in range(e_count)]).float() / idx.numel()
            self.aux_loss = self.alpha * (scores.mean(dim=0) * share * e_count).sum()
        return out.reshape(b, t, d)


class MoEBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, moe: dict, prec: Precision,
                 scaled: bool):
        super().__init__()
        self.attn = dit.Attention(dim, heads, prec, scaled)
        self.moe = MoE(dim, mlp_ratio, prec=prec, **moe)
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(dim, 6 * dim, prec)})

    def forward(self, x, c_act):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_modulation["1"](c_act).chunk(6, dim=1)
        x = x + gate_msa[:, None] * self.attn(dit.modulate(x, shift_msa, scale_msa))
        return x + gate_mlp[:, None] * self.moe(dit.modulate(x, shift_mlp, scale_mlp))


class DiTMoE(dit.DiT):
    """``dit.DiT`` with ``MoEBlock``s: the same inputs and outputs; in
    training mode ``aux_loss`` holds the blocks' auxiliary losses summed."""

    def __init__(self, in_channels: int = 1, input_size: int = 768, patch_size: int = 2,
                 hidden_size: int = 1152, depth: int = 28, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_classes: int = 5, num_experts: int = 8,
                 num_experts_per_tok: int = 2, n_shared_experts: int = 2,
                 aux_loss_alpha: float = 0.01, prec: Precision | None = None,
                 skip_block: int | None = None, attention_scale: bool = True,
                 top_k: int | None = None, renormalise: bool = False, no_shared: bool = False,
                 expert_shift: bool = False):
        prec = prec or Precision()
        super().__init__(in_channels, input_size, patch_size, hidden_size, 0, num_heads,
                         mlp_ratio, num_classes, prec, skip_block, attention_scale)
        moe = {"num_experts": num_experts, "top_k": top_k or num_experts_per_tok,
               "n_shared": n_shared_experts, "aux_loss_alpha": aux_loss_alpha,
               "renormalise": renormalise, "no_shared": no_shared,
               "expert_shift": expert_shift}
        self.blocks = nn.ModuleList([MoEBlock(hidden_size, num_heads, mlp_ratio, moe, prec,
                                              attention_scale) for _ in range(depth)])
        self.aux_loss = None

    def forward(self, x, t, y=None):
        out = super().forward(x, t, y)
        aux = [blk.moe.aux_loss for i, blk in enumerate(self.blocks)
               if i != self.skip_block and blk.moe.aux_loss is not None]
        self.aux_loss = torch.stack(aux).sum() if aux else None
        return out
