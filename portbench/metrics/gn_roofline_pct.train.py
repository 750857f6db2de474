"""K1's and K3's share of their roofline in the traced training steps: the
least time of every GroupNorm forward (encoder and UNet) and every UNet
GroupNorm backward of a step (``roofline.train_gn_bounds``, from the
configuration) over the device time of K1's and K3's kernels, named below."""
from portbench import harness, roofline
from portbench.drivers.train import latent_shape

KERNELS = ("gn_fwd_on_chip", "gn_fwd_cluster", "gn_finalize", "gn_apply", "gn_partial_stats",
           "gn_bwd_on_chip", "gn_bwd_cluster", "gn_bwd_rows", "gn_bwd_dx", "gn_bwd_params")


def read(run):
    trace, cfg = run["trace"], run["cfg"]
    busy = harness.device_seconds(trace, KERNELS)
    if not busy:
        return None
    work = trace["work"]
    bound = work["steps"] * roofline.train_gn_bounds(cfg["unet"], cfg["aekl"], work["batch"],
                                                     cfg["window"], latent_shape(cfg)[1],
                                                     cfg["dtype"])
    return 100.0 * bound / busy
