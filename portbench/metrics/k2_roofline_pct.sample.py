"""K2's share of its roofline in a sampled batch: the least time of the
GroupNorm -> SiLU -> Conv1d(k=3) chains that the batch's UNet forwards run
fused (counted from the configuration, ``roofline.sample_bounds``) over the
device time of K2's kernels, named below, in the traced batch."""
from portbench import harness, roofline

KERNELS = ("gn_silu_conv3_tc", "gn_silu_conv3_fp32", "gn_partial_stats")


def read(run):
    trace, cfg = run["trace"], run["cfg"]
    busy = harness.device_seconds(trace, KERNELS)
    if not busy:
        return None
    work = trace["work"]
    bound = work["unet_forwards"] * roofline.sample_bounds(cfg["unet"], work["batch"],
                                                           cfg["unet"]["image_size"], cfg["dtype"])
    return 100.0 * bound / busy
