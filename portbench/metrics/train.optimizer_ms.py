"""Device milliseconds per training step of Adam's update of the fp32 master
weights: ``trainer.optimizer`` spans, read as `train.encode_ms` reads
``trainer.encode``."""
from portbench import harness

phase_ms = harness.load_module("metrics", "train.encode_ms").phase_ms


def read(run):
    return phase_ms("trainer.optimizer")
