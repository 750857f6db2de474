"""Device milliseconds per training step of the noising, the UNet's forward
under autocast and the loss: ``trainer.forward`` spans, read as
`train.encode_ms` reads ``trainer.encode``."""
from portbench import harness

phase_ms = harness.load_module("metrics", "train.encode_ms").phase_ms


def read(run):
    return phase_ms("trainer.forward")
