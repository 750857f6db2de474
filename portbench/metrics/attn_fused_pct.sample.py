"""Share of the UNet's attention calls in the traced batch that ran the
program's hand-written attention kernel K5, in percent: the program's
``k5.traced_launches`` (K5's launches while its tracer recorded, a replayed
CUDA graph's included) over the batch's UNet forwards times the
configuration's attention blocks a forward. None where the program has no
such counter (a parent without K5) or no tracer, or the batch ran no
forward."""
from portbench import harness

tracer = harness.load_module("metrics", "sample.step_host_ms")


def attention_blocks(unet: dict) -> int:
    """Attention blocks of one UNet forward: one after each resblock of a
    level whose downsampling factor is in ``attention_resolutions`` (its
    ``num_res_blocks`` on the way down, one more on the way up), and the
    middle block's."""
    mult, nrb, attn = unet["channel_mult"], unet["num_res_blocks"], unet["attention_resolutions"]
    return 1 + sum(2 * nrb + 1 for level in range(len(mult)) if 2 ** level in attn)


def read(run):
    got = tracer.traced()
    counters = got[1] if got else {}
    forwards = ((run.get("trace") or {}).get("work") or {}).get("unet_forwards", 0)
    if "k5.traced_launches" not in counters or not forwards:
        return None
    return 100.0 * counters["k5.traced_launches"] / (forwards * attention_blocks(run["cfg"]["unet"]))
