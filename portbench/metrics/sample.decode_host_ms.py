"""Host milliseconds of the AEKL decode and the crop (``sampler.decode``
spans) per sampler call (``sampler.call``) in the traced batch."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def read(run):
    got = tracer.traced()
    if not got:
        return None
    calls, decodes = (tracer.named(got[0], n) for n in ("sampler.call", "sampler.decode"))
    if not calls or not decodes:
        return None
    return tracer.host_ms(decodes) / len(calls)
