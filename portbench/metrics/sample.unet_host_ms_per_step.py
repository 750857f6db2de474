"""Host milliseconds in the UNet's forward (``unet.forward`` spans inside a
``sampler.step``) per step of the traced batch: the module dispatch and the
kernel wrappers' host time under it."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def read(run):
    got = tracer.traced()
    if not got:
        return None
    steps = tracer.named(got[0], "sampler.step")
    ids = {s["id"] for s in steps}
    unet = [s for s in tracer.named(got[0], "unet.forward") if s["parent"] in ids]
    if not steps or not unet:
        return None
    return tracer.host_ms(unet) / len(steps)
