"""The DM training step's share of the card's dense bf16 peak: the
reference UNet's FLOPs of one step at the cell's batch (forward and
backward over the windows; no encode, no recomputation), counted on meta
tensors, over the unprofiled window's seconds per step and 989 TFLOP/s."""
from portbench import flops, harness

driver = harness.load_module("drivers", "train_dm")


def read(run):
    rec = run["record"]
    step_flops = driver.step_flops(run["cfg"], rec["batch"])
    return 100.0 * step_flops / rec["step_s"] / flops.PEAK_BF16_FLOPS
