"""Device milliseconds per denoising step in the DiT's MLP halves of its
blocks (LayerNorm and modulation, fc1, tanh GELU, fc2, the gated residual):
``dit.mlp`` spans, read as `dit.attn_ms_per_step` reads ``dit.attn``."""
from portbench import harness

per_forward_ms = harness.load_module("metrics", "dit.attn_ms_per_step").per_forward_ms


def read(run):
    return per_forward_ms("dit.mlp")
