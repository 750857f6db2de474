"""Mean host milliseconds of the ``sampler.step`` spans of the traced batch:
one denoising step's dispatch, the UNet's and the update's. The spans are
the program's own (``sleepgen_torch.utils.profiling``), which record only
while the profiler does, so they hold the traced sub-window alone. Where
the program has no tracer, or it recorded nothing, this reads None; so do
the other readers of the program's spans, which share ``traced`` and
``host_ms``."""


def traced():
    """(spans, counters) of the program's tracer in this process, or None."""
    try:
        from sleepgen_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    return (spans, profiling.counters()) if spans else None


def named(spans, name):
    return [s for s in spans if s["name"] == name]


def host_ms(spans) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6


def read(run):
    got = traced()
    steps = named(got[0], "sampler.step") if got else []
    if not steps:
        return None
    return host_ms(steps) / len(steps)
