"""The DiT-MoE sampler's share of the card's dense bf16 peak: the FLOPs per
window (the forward over the guided 2B batch times the steps, counted
analytically with each token through exactly k experts,
``sample_dit_moe.forward_flops``, plus the AEKL decode of the batch on meta
tensors) times the unprofiled window's windows/s, over 989 TFLOP/s."""
from portbench import flops, harness

driver = harness.load_module("drivers", "sample_dit_moe")


def read(run):
    rec, cfg = run["record"], run["cfg"]
    rate = rec.get("rate")
    if not rate:
        return None
    batch = rec["batch"]
    per_batch = (rec["steps"] * driver.forward_flops(cfg, 2 * batch)
                 + driver.decode_flops(cfg, batch))
    return 100.0 * rate * per_batch / batch / flops.PEAK_BF16_FLOPS
