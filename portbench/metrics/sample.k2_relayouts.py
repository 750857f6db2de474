"""K2's weight re-layouts (misses of its tile cache) made while the
program's tracer recorded (``k2.traced_relayouts``), per sampler call
(``sampler.call``) in the traced batch: 0 when the cache holds every
weight of the served UNet."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def read(run):
    got = tracer.traced()
    if not got:
        return None
    calls = tracer.named(got[0], "sampler.call")
    if not calls or "k2.traced_relayouts" not in got[1]:
        return None
    return got[1]["k2.traced_relayouts"] / len(calls)
