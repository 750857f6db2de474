"""Device milliseconds per training step of the backward pass (K3, cuDNN's
and SDPA's gradients): ``trainer.backward`` spans, read as
`train.encode_ms` reads ``trainer.encode``."""
from portbench import harness

phase_ms = harness.load_module("metrics", "train.encode_ms").phase_ms


def read(run):
    return phase_ms("trainer.backward")
