"""The stage-1 step's share of the card's dense bf16 peak: the reference's
FLOPs of one step at the cell's batch (the G step's autoencoder forward and
backward and discriminator forward and input gradient, the D step's two
discriminator forwards and its parameters' gradient; no recomputation),
counted on meta tensors, over the unprofiled window's seconds per step and
989 TFLOP/s."""
from portbench import flops, harness

driver = harness.load_module("drivers", "train_ae")


def read(run):
    rec = run["record"]
    step_flops = driver.step_flops(run["cfg"], rec["batch"])
    return 100.0 * step_flops / rec["step_s"] / flops.PEAK_BF16_FLOPS
