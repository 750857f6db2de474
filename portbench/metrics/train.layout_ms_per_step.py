"""Device milliseconds per training step in cuDNN's NCHW <-> NHWC layout
transposes, found by kernel name in the traced steps."""
from portbench import harness

KERNELS = ("nchwToNhwc", "nhwcToNchw")


def read(run):
    trace = run["trace"]
    busy = harness.device_seconds(trace, KERNELS)
    if not busy:
        return None
    return 1e3 * busy / trace["work"]["steps"]
