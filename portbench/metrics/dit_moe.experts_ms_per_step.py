"""Device milliseconds per denoising step in the routed experts: the two
grouped GEMMs and SiLU times up between them (``dit.moe.experts`` spans
inside the blocks' ``dit.mlp``), read as `dit.attn_ms_per_step` reads
``dit.attn``. None where the program has no such spans."""
from portbench import harness

per_forward_ms = harness.load_module("metrics", "dit.attn_ms_per_step").per_forward_ms


def read(run):
    return per_forward_ms("dit.moe.experts", ("dit.mlp",))
