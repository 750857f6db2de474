"""K1's and K3's share of their roofline in the traced DM training steps:
the least time of every UNet GroupNorm forward and backward of a step over
the (batch, 1, window) windows (``roofline.unet_forward`` with a gradient;
no encode, so none of the AEKL's) over the device time of K1's and K3's
kernels, named as ``gn_roofline_pct.train`` names them."""
from portbench import harness, roofline

KERNELS = harness.load_module("metrics", "gn_roofline_pct.train").KERNELS


def step_bound(unet: dict, batch: int, dtype: str = "bfloat16") -> float:
    """Least seconds of one DM training step's GroupNorm work."""
    norms = roofline.unet_forward(unet, batch, unet["image_size"], grad=True)["K1"]
    return sum(roofline.k1_bound(k, dtype) + roofline.k3_bound(k, dtype) for k in norms)


def read(run):
    trace, cfg = run["trace"], run["cfg"]
    busy = harness.device_seconds(trace, KERNELS)
    if not busy:
        return None
    work = trace["work"]
    return 100.0 * work["steps"] * step_bound(cfg["unet"], work["batch"], cfg["dtype"]) / busy
