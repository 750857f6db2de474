"""The benchmark's yardstick for kernels: published H100 peaks, the least
time of a GroupNorm (+SiLU) (K1), its backward (K3) and a GroupNorm ->
SiLU -> Conv1d(k=3) chain (K2) at a shape, and walks of the model
configurations that list every such chain a forward pass, a decode or a
training step runs.

The bounds are the arithmetic of the program's smoke script, copied
(``chip_smoke.py::k1_bound``, ``k2_bound``, ``k3_bound``): each input byte
read once and each output byte written once, at 3.35 TB/s, against the
operations at the bf16 tensor-core or fp32 CUDA-core peak; the least time
is the larger of the two. The walks follow the networks' structure from the
configuration alone, so a metric built on them reads the same work
whatever kernel implements it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# Published H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s, bf16
# tensor-core and fp32 CUDA-core operations/s.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
GN_OPS_PER_ELEMENT = 12  # stats 4, normalise + affine 4, SiLU 4
# backward: xhat 2, z 2, sigmoid 3, dz 5, dxhat 1, row sums 3, dx 4
GN_BWD_OPS_PER_ELEMENT = 20
ITEMSIZE = {"bfloat16": 2, "float32": 4}

# (B, C, L, G) of a GroupNorm; (B, C_in, C_out, L, G) of a K2 chain
GN = Tuple[int, int, int, int]
Chain = Tuple[int, int, int, int, int]


def k1_bound(key: GN, dtype: str = "bfloat16") -> float:
    """Least seconds of GroupNorm (+SiLU) over (B, C, L)."""
    b, c, l, _ = key
    n = b * c * l
    t_bytes = (2 * n * ITEMSIZE[dtype] + 8 * c) / HBM_BYTES_PER_S
    return max(t_bytes, GN_OPS_PER_ELEMENT * n / FP32_OPS_PER_S)


def k2_bound(key: Chain, dtype: str = "bfloat16") -> float:
    """Least seconds of GroupNorm -> SiLU -> Conv1d(k=3) + bias: the
    convolution's products and the norm's fp32 work can overlap, so the
    least time is the largest of the bytes, the products and the norm."""
    b, cin, cout, l, _ = key
    t_bytes = ((b * cin * l + cout * cin * 3 + cout + b * cout * l) * ITEMSIZE[dtype]
               + 8 * cin) / HBM_BYTES_PER_S
    rate = BF16_TC_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_ops = max(2 * 3 * b * l * cin * cout / rate, GN_OPS_PER_ELEMENT * b * cin * l / FP32_OPS_PER_S)
    return max(t_bytes, t_ops)


def k3_bound(key: GN, dtype: str = "bfloat16") -> float:
    """Least seconds of the backward: read x and dy, write dx, plus the
    (B, G) statistics and the (C,) scale, bias and their gradients."""
    b, c, l, g = key
    n = b * c * l
    t_bytes = (3 * n * ITEMSIZE[dtype] + 8 * b * g + 16 * c) / HBM_BYTES_PER_S
    return max(t_bytes, GN_BWD_OPS_PER_ELEMENT * n / FP32_OPS_PER_S)


def unet_forward(unet: dict, batch: int, length: int, grad: bool = False) -> Dict[str, List]:
    """The GroupNorms of one UNet forward at (batch, length): ``K2`` the
    GroupNorm -> SiLU -> Conv1d(k=3) chains that run fused when no gradient
    is needed (both chains of a resblock that does not resample, the second
    of one that does), ``K1`` every other GroupNorm (the first chain of a
    resampling resblock, the attention norms, the output norm), as
    (B, C, L, G). With ``grad`` every GroupNorm is a K1 (and K3 in the
    backward): listed under ``K1`` alone, chains included."""
    mc, g = unet["model_channels"], unet["norm_num_groups"]
    mult, nrb, attn = unet["channel_mult"], unet["num_res_blocks"], unet["attention_resolutions"]
    k1: List[GN] = []
    k2: List[Chain] = []

    def res(cin, cout, l, resample=None):
        lo = l * 2 if resample == "up" else l // 2 if resample == "down" else l
        if resample or grad:
            k1.append((batch, cin, l, g))
        else:
            k2.append((batch, cin, cout, l, g))
        if grad:
            k1.append((batch, cout, lo, g))
        else:
            k2.append((batch, cout, cout, lo, g))
        return lo

    def att(ch, l):
        k1.append((batch, ch, l, g))

    skips, ch, ds, l = [mc], mc, 1, length
    for level, m in enumerate(mult):
        for _ in range(nrb):
            res(ch, m * mc, l)
            ch = m * mc
            if ds in attn:
                att(ch, l)
            skips.append(ch)
        if level != len(mult) - 1:
            l = res(ch, ch, l, "down")
            skips.append(ch)
            ds *= 2
    res(ch, ch, l)
    att(ch, l)
    res(ch, ch, l)
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            res(ch + skips.pop(), mult[level] * mc, l)
            ch = mult[level] * mc
            if ds in attn:
                att(ch, l)
            if level > 0 and i == nrb:
                l = res(ch, ch, l, "up")
                ds //= 2
    k1.append((batch, ch, l, g))  # the output norm, then SiLU
    return {"K1": k1, "K2": k2}


def _coder(aekl: dict, batch: int, length: int, decoder: bool) -> List[GN]:
    chans = list(aekl["num_channels"])
    g, nrb = aekl["norm_num_groups"], aekl["num_res_blocks"]
    if decoder:
        chans = chans[::-1]
    out: List[GN] = []
    ch, l = chans[0], length
    for level, c_out in enumerate(chans):
        for _ in range(nrb):
            out += [(batch, ch, l, g), (batch, c_out, l, g)]
            ch = c_out
        if level != len(chans) - 1:
            l = l * 2 if decoder else (l + 1) // 2
    out.append((batch, ch, l, g))  # norm_out
    return out


def encoder_norms(aekl: dict, batch: int, length: int) -> List[GN]:
    """The AEKL encoder's GroupNorms over (batch, 1, length) windows."""
    return _coder(aekl, batch, length, decoder=False)


def decoder_norms(aekl: dict, batch: int, latent_length: int) -> List[GN]:
    """The AEKL decoder's GroupNorms from (batch, latent, latent_length)."""
    return _coder(aekl, batch, latent_length, decoder=True)


def sample_bounds(unet: dict, batch: int, length: int, dtype: str = "bfloat16") -> float:
    """Least seconds of one no-gradient UNet forward's K2 chains."""
    return sum(k2_bound(c, dtype) for c in unet_forward(unet, batch, length)["K2"])


def train_gn_bounds(unet: dict, aekl: dict, batch: int, window: int, latent: int,
                    dtype: str = "bfloat16") -> float:
    """Least seconds of one stage-2 training step's GroupNorm work: every
    encoder and UNet GroupNorm forward and every UNet GroupNorm backward."""
    unet_norms = unet_forward(unet, batch, latent, grad=True)["K1"]
    return (sum(k1_bound(k, dtype) for k in encoder_norms(aekl, batch, window) + unet_norms)
            + sum(k3_bound(k, dtype) for k in unet_norms))


def expected_launches(unet: dict, aekl: dict, unet_forwards: int, decodes: int) -> dict:
    """Kernel launches of a sampler, counted from the configuration as the
    program's smoke script counts them (``chip_smoke.py::expected_launches``):
    K2 runs both chains of every plain resblock and chain 2 of every
    resampling one; K1 runs chain 1 of the resampling resblocks, every
    attention norm and the UNet's output norm, and every decoder GroupNorm."""
    levels, nrb = len(unet["channel_mult"]), unet["num_res_blocks"]
    plain = levels * nrb + 2 + levels * (nrb + 1)
    resampling = 2 * (levels - 1)
    attn = 1 + sum(2 * nrb + 1 for level in range(levels)
                   if 2 ** level in unet["attention_resolutions"])
    coder_gn = 2 * len(aekl["num_channels"]) * aekl["num_res_blocks"] + 1
    return {"K1": unet_forwards * (resampling + attn + 1) + decodes * coder_gn,
            "K2": unet_forwards * (2 * plain + resampling)}
