"""Host microseconds a launch of K1 and K2 in the traced batch: the
wrappers' time from entry to return (``k1.host_ns`` + ``k2.host_ns``, the
program's counters while its tracer records) over the launches they cover
(``k1.traced_launches`` + ``k2.traced_launches``)."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def read(run):
    got = tracer.traced()
    if not got or not tracer.named(got[0], "sampler.call"):
        return None
    c = got[1]
    launches = c.get("k1.traced_launches", 0) + c.get("k2.traced_launches", 0)
    if not launches:
        return None
    return (c["k1.host_ns"] + c["k2.host_ns"]) / launches / 1e3
