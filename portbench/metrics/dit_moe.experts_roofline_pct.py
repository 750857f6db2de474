"""The routed experts' share of their roofline in the traced batch: the
least time of every layer's experts (``sample_dit_moe.experts_bound``:
their products at the bf16 peak or their bytes at 3.35 TB/s, whichever is
larger, at the layer's routed rows, the program's ``dit.routed_rows`` over
its ``dit.moe_layers``) over the device time of the ``dit.moe.experts``
spans. None where the program has no such spans or counters."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")
driver = harness.load_module("drivers", "sample_dit_moe")


def read(run):
    got = tracer.traced()
    if not got:
        return None
    spans = tracer.named(got[0], "dit.moe.experts")
    layers, rows = got[1].get("dit.moe_layers"), got[1].get("dit.routed_rows")
    if not spans or not layers or any(s["device_ms"] is None for s in spans):
        return None
    bound = layers * driver.experts_bound(run["cfg"], rows // layers)
    return 100.0 * bound / (1e-3 * sum(s["device_ms"] for s in spans))
