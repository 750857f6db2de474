"""Device milliseconds per training step of the frozen encode: the CUDA
events the program's tracer records on the stream at the open and close
of each ``trainer.encode`` span inside a ``trainer.step``, summed over the
traced steps and divided by their number. The card is busy all through
the step, so the time between the events is the phase's device time.
None off CUDA or where the program has no tracer; ``phase_ms`` is shared
with the other phases' readers."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def phase_ms(name):
    got = tracer.traced()
    if not got:
        return None
    steps = {s["id"] for s in tracer.named(got[0], "trainer.step")}
    phases = [s for s in tracer.named(got[0], name) if s["parent"] in steps]
    if not steps or not phases or any(s["device_ms"] is None for s in phases):
        return None
    return sum(s["device_ms"] for s in phases) / len(steps)


def read(run):
    return phase_ms("trainer.encode")
