"""Share of the DiT's passes between half-blocks (the gated residual,
LayerNorm, adaLN modulation and the cast, 2 depth + 1 a forward) that ran
the program's hand-written kernel K4 in the traced batch, in percent: the
program's ``dit.fused_norms`` over (2 depth + 1) times its ``dit.forwards``,
both counted while its tracer recorded. None where the program has no such
counter (a parent without K4) or no tracer, or recorded no forward."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def read(run):
    got = tracer.traced()
    counters = got[1] if got else {}
    if "dit.fused_norms" not in counters or not counters.get("dit.forwards"):
        return None
    passes = (2 * run["cfg"]["dit"]["depth"] + 1) * counters["dit.forwards"]
    return 100.0 * counters["dit.fused_norms"] / passes
