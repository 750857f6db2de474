"""The training step's share of the card's dense bf16 peak: the reference's
FLOPs of one step at the cell's batch (the frozen encoder's forward, the
UNet's forward and backward; no recomputation), counted on meta tensors,
over the unprofiled window's seconds per step and 989 TFLOP/s."""
from portbench import flops


def read(run):
    rec = run["record"]
    return 100.0 * flops.train_step(run["cfg"], rec["batch"]) / rec["step_s"] / flops.PEAK_BF16_FLOPS
