"""Sparse mixture of SwiGLU experts with shared experts, the MLP of a
DiT-MoE block (Fei et al. 2024, "Scaling Diffusion Transformers to 16
Billion Parameters", arXiv:2407.11633; ``feizc/DiT-MoE``, ``models.py``).

The published layer, under its module names (``MoEGate``, ``MoeMLP``,
``SparseMoeBlock``): for each token u (the modulated LayerNorm of the
stream, width D)

* the gate: ``p = softmax(W_g u)``, ``W_g`` (E, D) without bias, scored in
  fp32; the top k of E are kept with their probabilities as weights, not
  renormalised (``norm_topk_prob`` False);
* the routed part: ``sum_{e in topk} p_e E_e(u)``, each expert a SwiGLU
  without biases, ``E_e(u) = W_down,e (SiLU(W_gate,e u) * W_up,e u)`` of
  intermediate width ``mlp_ratio`` D;
* the shared part: ``+ S(u)``, the ``n_shared_experts`` shared experts as
  one SwiGLU of intermediate width ``n_shared_experts`` D, on every token;
* in training, the gate's auxiliary loss (``seq_aux`` False): ``alpha *
  sum_e P_e f_e``, ``P_e`` the mean probability of expert e over the
  tokens and ``f_e`` E times the share of the routed slots that went to e.

The dispatch (``SparseMoeBlock.forward``) never reads a size back to the
host, so an eager sampling loop keeps the card fed: one (tokens, E) GEMM,
softmax and top-k; a stable sort of the tokens x k routed slots by expert,
whose per-expert end offsets come from ``searchsorted`` over the sorted
experts (``bincount``, ``nonzero``, boolean masks, ``.item()`` and
``.tolist()`` would each wait for the card); a gather of the slots' rows;
the experts as two grouped GEMMs over the sorted rows (``torch._grouped_mm``
with the offsets on the device: gate and up stacked as one (E, D, 2 I)
product, SiLU times up, then down); and the combine, each slot scaled by
its router weight and a token's k slots summed in fp32 in slot order, plus
the shared experts, cast to the compute dtype. The CPU runs the same
dispatch.

Parameters: the routed experts are held stacked, ``experts.gate_up`` (E, 2
I, D) and ``experts.down`` (E, D, I), the operands the grouped GEMMs take;
the state dict carries the published per-expert names
(``experts.3.gate_proj.weight``, ``.up_proj.weight``, ``.down_proj.weight``),
which hooks split off and stack back on loading.

Precision: the grouped GEMMs run in the compute dtype (autocast's in
training, the weights' under ``cast_compute_dtype``); on CUDA they take
bf16 alone and raise on any other dtype. The router's softmax, its
weights and the combine's sum are fp32.

Tracing (``utils.profiling``), inside the block's ``dit.mlp`` span:
``dit.moe.route`` (the gate's GEMM, softmax, top-k, the sort and the
offsets), ``dit.moe.dispatch`` (the gather), ``dit.moe.experts`` (the
routed grouped GEMMs and SiLU times up), ``dit.moe.shared`` and
``dit.moe.combine``. While the tracer records, ``dit.moe_layers`` counts the
layers run, ``dit.routed_rows`` their routed slots (tokens x k) and the
keyed ``dit.expert_rows`` each expert's rows, tallied on the device and
read once, by ``profiling.keyed``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sleepgen_torch.utils import profiling
from sleepgen_torch.utils.profiling import span

# Routed layers and slots while the tracer records; ``dit.expert_rows`` is
# a keyed device tally (``profiling.tally``)
profiling.register("dit.moe_layers", "dit.routed_rows", traced=True)
_PROJ = ("gate_proj", "up_proj", "down_proj")


def compute_dtype(x: torch.Tensor, param_dtype: torch.dtype) -> torch.dtype:
    """Autocast's dtype where autocast is on for ``x``'s device, else the
    parameters'."""
    kind = x.device.type
    if torch.is_autocast_enabled(kind):
        return torch.get_autocast_dtype(kind)
    return param_dtype


class MoEGate(nn.Module):
    """The router: (N, D) tokens -> top-k expert indices (N, k), their fp32
    probabilities (N, k) and every probability (N, E)."""

    def __init__(self, embed_dim: int, num_experts: int, num_experts_per_tok: int,
                 aux_loss_alpha: float = 0.01):
        super().__init__()
        self.top_k, self.n_routed_experts, self.alpha = (num_experts_per_tok, num_experts,
                                                         aux_loss_alpha)
        self.weight = nn.Parameter(torch.empty(num_experts, embed_dim))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))  # the published reset_parameters

    def forward(self, u: torch.Tensor):
        scores = F.linear(u, self.weight).float().softmax(dim=-1)
        weight, idx = torch.topk(scores, self.top_k, dim=-1)
        return idx, weight, scores

    def aux_loss(self, idx: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        """``alpha * sum_e P_e f_e`` over these tokens; ``f_e`` carries no
        gradient."""
        e = self.n_routed_experts
        share = torch.zeros(e, device=idx.device).scatter_add_(
            0, idx.reshape(-1), torch.ones(idx.numel(), device=idx.device)) / idx.numel()
        return self.alpha * (scores.mean(dim=0) * share * e).sum()


class MoeMLP(nn.Module):
    """A SwiGLU without biases: ``down(SiLU(gate(x)) * up(x))``."""

    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden_size, intermediate_size, bias=False)
        self.up_proj = nn.Linear(hidden_size, intermediate_size, bias=False)
        self.down_proj = nn.Linear(intermediate_size, hidden_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Experts(nn.Module):
    """E routed ``MoeMLP``s held stacked for the grouped GEMMs: ``gate_up``
    (E, 2 I, D), each expert's gate rows then its up rows, and ``down`` (E,
    D, I); in the state dict as ``<e>.gate_proj.weight``, ``<e>.up_proj.weight``
    and ``<e>.down_proj.weight``, the published names."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.num_experts, self.intermediate = num_experts, intermediate_size
        # nn.Linear's default initialisation, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        self.gate_up = nn.Parameter(torch.empty(num_experts, 2 * intermediate_size, hidden_size))
        self.down = nn.Parameter(torch.empty(num_experts, hidden_size, intermediate_size))
        for w in (self.gate_up, self.down):
            bound = w.shape[-1] ** -0.5
            nn.init.uniform_(w, -bound, bound)
        self._register_state_dict_hook(Experts._published_names)
        self._register_load_state_dict_pre_hook(Experts._stack_published, with_module=True)

    @staticmethod
    def _published_names(module, state, prefix, _meta):
        gate_up, down = state.pop(prefix + "gate_up"), state.pop(prefix + "down")
        i = module.intermediate
        for e in range(module.num_experts):
            for name, w in zip(_PROJ, (gate_up[e, :i], gate_up[e, i:], down[e])):
                state[f"{prefix}{e}.{name}.weight"] = w
        return state

    def _stack_published(self, state, prefix, *_):
        names = [[f"{prefix}{e}.{p}.weight" for p in _PROJ] for e in range(self.num_experts)]
        if not all(n in state for row in names for n in row):
            return  # strict loading reports what is missing
        per = [[state.pop(n) for n in row] for row in names]
        state[prefix + "gate_up"] = torch.stack([torch.cat([g, u]) for g, u, _ in per])
        state[prefix + "down"] = torch.stack([d for _, _, d in per])

    def forward(self, rows: torch.Tensor, ends: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(S, D) rows sorted by expert, expert e's ending at ``ends[e]``
        (int32, on the device) -> (S, D) in ``dtype``."""
        if rows.is_cuda and dtype != torch.bfloat16:
            raise ValueError(f"the routed experts' grouped GEMMs take bf16 on CUDA, not {dtype}")
        rows = rows.to(dtype)
        h = torch._grouped_mm(rows, self.gate_up.to(dtype).transpose(1, 2), offs=ends)
        i = self.intermediate
        act = F.silu(h[:, :i]) * h[:, i:]
        return torch._grouped_mm(act, self.down.to(dtype).transpose(1, 2), offs=ends)


class SparseMoeBlock(nn.Module):
    """(B, T, D) -> (B, T, D) in the compute dtype: the routed experts
    (``experts``), the router (``gate``) and the shared experts
    (``shared_experts``, absent with ``n_shared_experts`` 0). In training
    (module in training mode, autograd on, ``aux_loss_alpha`` > 0) the
    forward leaves the gate's auxiliary loss in ``aux_loss``, else None."""

    def __init__(self, embed_dim: int, mlp_ratio: float = 4.0, num_experts: int = 8,
                 num_experts_per_tok: int = 2, n_shared_experts: int = 2,
                 aux_loss_alpha: float = 0.01):
        super().__init__()
        if not 0 < num_experts_per_tok <= num_experts:
            raise ValueError(f"top {num_experts_per_tok} of {num_experts} experts")
        self.num_experts_per_tok = num_experts_per_tok
        self.experts = Experts(num_experts, embed_dim, int(embed_dim * mlp_ratio))
        self.gate = MoEGate(embed_dim, num_experts, num_experts_per_tok, aux_loss_alpha)
        if n_shared_experts:
            self.shared_experts = MoeMLP(embed_dim, embed_dim * n_shared_experts)
        self.n_shared_experts = n_shared_experts
        self.register_buffer("_experts", torch.arange(num_experts), persistent=False)
        self.aux_loss: Optional[torch.Tensor] = None

    def route(self, u: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(weights (N, k) fp32, scores (N, E), experts (N, k), the slots'
        order sorted by expert (N k,), each expert's end offset (E,) int32):
        slot j of token n is n k + j."""
        idx, weight, scores = self.gate(u)
        sorted_experts, order = torch.sort(idx.reshape(-1), stable=True)
        ends = torch.searchsorted(sorted_experts, self._experts, right=True)
        return weight, scores, idx, order, ends.to(torch.int32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        u = x.reshape(b * t, d)
        k = self.num_experts_per_tok
        dtype = compute_dtype(x, self.experts.down.dtype)
        profiling.count("dit.moe_layers")
        profiling.count("dit.routed_rows", b * t * k)
        with span("dit.moe.route"):
            weight, scores, idx, order, ends = self.route(u)
            if profiling.recording():
                profiling.tally("dit.expert_rows", torch.diff(ends, prepend=ends.new_zeros(1)))
        with span("dit.moe.dispatch"):
            rows = u.index_select(0, order // k)
        with span("dit.moe.experts"):
            y = self.experts(rows, ends, dtype)
        shared = None
        if self.n_shared_experts:
            with span("dit.moe.shared"):
                shared = self.shared_experts(u)
        with span("dit.moe.combine"):
            slot_of = torch.empty_like(order).scatter_(
                0, order, torch.arange(order.numel(), device=order.device))
            out = (y.index_select(0, slot_of).view(b * t, k, d).float()
                   * weight.unsqueeze(-1)).sum(dim=1)
            if shared is not None:
                out = out + shared.float()
            out = out.to(dtype)
        training = self.training and torch.is_grad_enabled() and self.gate.alpha > 0
        self.aux_loss = self.gate.aux_loss(idx, scores) if training else None
        return out.view(b, t, d)

