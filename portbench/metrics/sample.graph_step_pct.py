"""Share of the traced batch's denoising steps that ran as one replay of the
sampler's CUDA graph, in percent: the program's
``sampler.traced_graph_replays`` (replays made while its tracer recorded)
over the batch's ``sampler.step`` spans. None where the program has no
such counter (a parent without the graphs) or no tracer, where it recorded
no step, and off CUDA (its spans carry no device time there)."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def read(run):
    got = tracer.traced()
    steps = tracer.named(got[0], "sampler.step") if got else []
    if not steps or "sampler.traced_graph_replays" not in got[1]:
        return None
    if all(s["device_ms"] is None for s in steps):
        return None
    return 100.0 * got[1]["sampler.traced_graph_replays"] / len(steps)
