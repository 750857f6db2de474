"""Device milliseconds per denoising step in the sparse layer's own work
around its experts: the router's GEMM, softmax, top-k, the sort and the
offsets (``dit.moe.route``), the gather of the routed rows
(``dit.moe.dispatch``) and the weighted combine (``dit.moe.combine``),
spans inside the blocks' ``dit.mlp``, read as `dit.attn_ms_per_step` reads
``dit.attn``. None where the program has no such spans."""
from portbench import harness

per_forward_ms = harness.load_module("metrics", "dit.attn_ms_per_step").per_forward_ms


def read(run):
    parts = [per_forward_ms(name, ("dit.mlp",))
             for name in ("dit.moe.route", "dit.moe.dispatch", "dit.moe.combine")]
    return None if None in parts else sum(parts)
