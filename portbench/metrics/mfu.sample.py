"""The sampler's share of the card's dense bf16 peak: the reference's FLOPs
per window (the UNet forward at the cell's batch times its steps, plus the
AEKL decode where the configuration has one), counted on meta tensors,
times the unprofiled window's windows/s, over 989 TFLOP/s."""
from portbench import flops


def read(run):
    rec, cfg = run["record"], run["cfg"]
    rate = rec.get("rate")
    if not rate:
        return None
    per_batch = rec["steps"] * flops.unet_forward(cfg, rec["batch"])
    if "aekl" in cfg:
        per_batch += flops.decode(cfg, rec["batch"])
    return 100.0 * rate * per_batch / rec["batch"] / flops.PEAK_BF16_FLOPS
