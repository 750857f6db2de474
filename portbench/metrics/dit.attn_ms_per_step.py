"""Device milliseconds per denoising step in the DiT's attention halves of
its blocks (LayerNorm and modulation, qkv, SDPA, the output projection and
the gated residual): the CUDA events the program's tracer records at the
open and close of each ``dit.attn`` span inside a ``dit.forward``, summed
over the traced batch and divided by its forwards (one a step). The card
is busy through the forward, so the time between the events is the span's
device time. None off CUDA or where the program has no such spans;
``per_forward_ms`` is shared with the MLP's and the modulation's readers."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def per_forward_ms(name, parents=("dit.forward",)):
    """Device ms of the ``name`` spans whose parent is one of ``parents``,
    per ``dit.forward`` span."""
    got = tracer.traced()
    if not got:
        return None
    forwards = tracer.named(got[0], "dit.forward")
    ids = {s["id"] for p in parents for s in tracer.named(got[0], p)}
    spans = [s for s in tracer.named(got[0], name) if s["parent"] in ids]
    if not forwards or not spans or any(s["device_ms"] is None for s in spans):
        return None
    return sum(s["device_ms"] for s in spans) / len(forwards)


def read(run):
    return per_forward_ms("dit.attn")
