"""Device milliseconds per denoising step in the DiT's LayerNorm and adaLN
modulation (two a block, inside its attention and its MLP): ``dit.modulate``
spans whose parent is a ``dit.attn`` or ``dit.mlp`` span, read as
`dit.attn_ms_per_step` reads ``dit.attn``. The final layer's modulation is
not counted."""
from portbench import harness

per_forward_ms = harness.load_module("metrics", "dit.attn_ms_per_step").per_forward_ms


def read(run):
    return per_forward_ms("dit.modulate", ("dit.attn", "dit.mlp"))
