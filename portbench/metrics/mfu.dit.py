"""The DiT sampler's share of the card's dense bf16 peak: the reference's
FLOPs per window (the DiT forward over the guided 2B batch times the
steps, plus the AEKL decode of the batch), counted on meta tensors, times
the unprofiled window's windows/s, over 989 TFLOP/s."""
from portbench import flops, harness

driver = harness.load_module("drivers", "sample_dit")


def read(run):
    rec, cfg = run["record"], run["cfg"]
    rate = rec.get("rate")
    if not rate:
        return None
    batch = rec["batch"]
    per_batch = (rec["steps"] * driver.forward_flops(cfg, 2 * batch)
                 + driver.decode_flops(cfg, batch))
    return 100.0 * rate * per_batch / batch / flops.PEAK_BF16_FLOPS
