"""K2's fp32 formulation, checked on the CPU before the card runs it.

The fp32 kernel (``gn_silu_conv3_fp32`` in csrc/gn_silu_conv3.cu) cannot
run here, so its decomposition is written out in plain PyTorch, in the
kernel's own order of operations, on the weights read back from the
wrapper's own re-layout (``fp32_conv_tiles``), and held to the JAX package
in fp32 at rtol 1e-5 / atol 1e-6 sqrt(C_in / 16):

* the group statistics of the shared split reduction (gn_stats.cuh): per
  2048-element chunk a two-pass (count, mean, M2), the chunks merged in
  order with Chan's formula, rstd = 1 / sqrt(M2 / n + eps);
* per block of TN output channels (64 for C_out <= 64, else 128) and TL
  positions (96 or 48), the tile of h over positions l0 - 1 .. l0 + TL
  (the +-1 halo, zero outside [0, L)), made per chunk of 32 input channels
  with the folded affine a_c = rstd scale_c, d_c = fma(-mean, a_c,
  bias_c), h = silu(fma(a_c, x, d_c));
* two K-groups a block, K-group g summing channels 32 kc + 16 g .. + 15 of
  every chunk kc in order, then taps 0, 1, 2, with one fma per product
  (emulated in float64 and rounded once, as fmaf rounds), and y = (sum_0 +
  sum_1) + b.

TN, TL, the chunk and the two K-groups are the kernel's (fp::KC, fp::KG,
and TL = fp::PT fp::KTH fp::QT / TN in csrc/gn_silu_conv3.cu); the test
copies them from there, apart from TN and the chunk, which it reads from
the wrapper the kernel's weights come from.

Held to ``gn_silu_conv3_reference`` and the Pallas
``fused_gn_silu_conv3_tiled`` (interpret mode, as
tests/test_torch_port_kernels.py runs it), at the nine shapes the v1
ancestral sampler gives K2 (batch 2) and at the tile's edges. Inputs are
made with numpy from a seed; JAX takes (B, L, C), the port (B, C, L).

The atol grows with sqrt(C_in), as the bound of K3's dscale and dbias
grows with sqrt(B L) (tests/test_torch_cuda_kernels.py): y sums 3 C_in
fp32 products, and each order of that sum rounds differently, by about
sqrt(3 C_in) ulps of |y| (up to about 3 on these inputs), so the walk,
the jnp reference and the Pallas kernel, each summing in its own order,
differ by more than a flat 1e-6 from C_in 128 on, on rounding alone.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sleepgen.pallas_kernels.fused_resblock import (fused_gn_silu_conv3_tiled,
                                                    gn_silu_conv3_reference)
from sleepgen_torch.kernels import fused_resblock
from sleepgen_torch.kernels.fused_resblock import FP32_CHUNK, fp32_conv_tiles, fp32_tile_n

RTOL, ATOL = 1e-5, 1e-6  # ATOL per 16 input channels; scaled by sqrt(C_in / 16)
STATS_CHUNK = 2048  # kStatsChunk in csrc/gn_stats.cuh
K_GROUPS = 2  # fp::KG in csrc/gn_silu_conv3.cu
CK = FP32_CHUNK // K_GROUPS  # fp::CK: input channels of a chunk per K-group
BLOCK_OUTPUTS = 12 * 128 * 4  # fp::PT x fp::KTH x fp::QT: TL = BLOCK_OUTPUTS / TN


def tile_positions(tn: int) -> int:
    """TL of the fp32 block: 48 for TN 128, 96 for TN 64."""
    return BLOCK_OUTPUTS // tn


# (C_in, C_out, L): every shape the v1 ancestral sampler gives K2
# (tests/test_torch_cuda_kernels.py::V1_UNET_K2_SHAPES), here at batch 2, G 32
V1_SHAPES = [(64, 64, 768), (64, 64, 384), (64, 128, 384), (128, 128, 384), (256, 128, 384),
             (192, 128, 384), (128, 128, 768), (192, 64, 768), (128, 64, 768)]
# (B, C_in, C_out, L, G): C_out 40, 136, 192 (part tiles); L 8, 37, 130, 1000
# (shorter than a tile, ragged); C_in 24, 96 (part chunks); G 4 to 64; batch 1
EDGE_SHAPES = [(1, 24, 40, 37, 4), (2, 96, 136, 130, 8), (1, 64, 192, 8, 64),
               (1, 96, 64, 1000, 32), (2, 24, 136, 8, 8), (1, 128, 40, 130, 64)]
CASES = ([pytest.param(2, cin, cout, l, 32, id=f"v1-{cin}-{cout}-{l}")
          for cin, cout, l in V1_SHAPES]
         + [pytest.param(*s, id="edge-" + "-".join(map(str, s))) for s in EDGE_SHAPES])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: the suite runs several
    worker processes on the same cores, where each process's spinning
    thread pool slows every small op of the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, cin, cout, l, seed=0):
    """x (B, C_in, L), scale, bias, w (C_out, C_in, 3), b as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, cin, l)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.normal(size=cin)).astype(np.float32)
    bias = (0.2 * rng.normal(size=cin)).astype(np.float32)
    w = (rng.normal(size=(cout, cin, 3)) / np.sqrt(3 * cin)).astype(np.float32)
    bb = (0.1 * rng.normal(size=cout)).astype(np.float32)
    return x, scale, bias, w, bb


@functools.lru_cache(maxsize=None)
def _jax(b, cin, cout, l, g):
    """(reference, Pallas in interpret mode) at the case's inputs, (B, C_out, L)."""
    x, scale, bias, w, bb = _inputs(b, cin, cout, l)
    args = (jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(scale), jnp.asarray(bias),
            jnp.asarray(w.transpose(2, 1, 0)), jnp.asarray(bb))  # JAX: (B, L, C), (3, C_in, C_out)
    return tuple(np.asarray(y).transpose(0, 2, 1) for y in
                 (gn_silu_conv3_reference(*args, g),
                  fused_gn_silu_conv3_tiled(*args, g, interpret=True)))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf: a * b + c rounded once to fp32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _stats(x: torch.Tensor, g: int, eps: float = 1e-6):
    """gn_stats.cuh: per 2048-element chunk (count, mean, M2) by two passes,
    merged in order with Chan's formula (merge_group) -> mean, rstd (B, G)."""
    b = x.shape[0]
    xg = x.reshape(b, g, -1)
    n_tot = xg.shape[-1]
    n = mean = m2 = torch.zeros(b, g)
    for start in range(0, n_tot, STATS_CHUNK):
        part = xg[..., start:start + STATS_CHUNK]
        cnt = torch.tensor(float(part.shape[-1]))
        cm = part.sum(-1) / cnt
        cq = (part - cm[..., None]).square().sum(-1)
        nn = n + cnt
        delta = cm - mean
        mean = mean + delta * (cnt / nn)
        m2 = m2 + (cq + delta * delta * (n / nn) * cnt)
        n = nn
    return mean, torch.rsqrt(m2 / n + eps)


def kernel_walk(x, scale, bias, w, bb, g, eps=1e-6):
    """The fp32 kernel's arithmetic, tile by tile: (B, C_out, L) fp32."""
    b, cin, l = x.shape
    cout = w.shape[0]
    tn = fp32_tile_n(cout)
    tl = tile_positions(tn)
    tiles = fp32_conv_tiles(w)  # (NT, NK, 32, 3, TN)
    nt, nk = tiles.shape[:2]
    npos = -(-l // tl)
    mean, rstd = _stats(x, g, eps)
    cpg = cin // g
    # raw x at each block's positions l0 - 1 .. l0 + TL (zero outside [0, L)
    # and past C_in): (B, C_in padded, tiles, TL + 2)
    xp = F.pad(x, (1, npos * tl + 1 - l, 0, nk * FP32_CHUNK - cin))
    inside = F.pad(torch.ones(l), (1, npos * tl + 1 - l)).unfold(0, tl + 2, tl)
    xt = xp.unfold(2, tl + 2, tl)
    y = torch.empty(b, nt * tn, npos, tl)
    for t in range(nt):
        sums = [torch.zeros(b, tn, npos, tl) for _ in range(K_GROUPS)]
        for kc in range(nk):
            for kg in range(K_GROUPS):
                for i in range(CK):
                    ci = kc * FP32_CHUNK + kg * CK + i
                    if ci < cin:  # the folded affine, then h (zero outside the row)
                        a = rstd[:, ci // cpg] * scale[ci]
                        d = _fma(-mean[:, ci // cpg], a, bias[ci].expand_as(a))
                        v = _fma(a[:, None, None], xt[:, ci], d[:, None, None].expand_as(xt[:, ci]))
                        h = torch.where(inside > 0, v / (1 + torch.exp(-v)), 0.0)
                    else:  # past C_in: zero raw x, zero affine, silu(0) = 0
                        h = torch.zeros(b, npos, tl + 2)
                    for k in range(3):
                        wk = tiles[t, kc, kg * CK + i, k]  # (TN,)
                        sums[kg] = _fma(wk[None, :, None, None], h[:, None, :, k:k + tl],
                                        sums[kg])
        bt = F.pad(bb, (0, nt * tn - cout))[t * tn:(t + 1) * tn]
        y[:, t * tn:(t + 1) * tn] = (sums[0] + sums[1]) + bt[None, :, None, None]
    return y.reshape(b, nt * tn, npos * tl)[:, :cout, :l]


@pytest.mark.parametrize("cout,cin", [(64, 64), (40, 24), (136, 96), (192, 64), (128, 256),
                                      (1, 1)])
def test_fp32_conv_tiles_layout(cout, cin):
    """Entry [t, c, i, k, n] is W[TN t + n, 32 c + i, k], zero past C_out and C_in."""
    w = torch.randn(cout, cin, 3)
    tiles = fp32_conv_tiles(w)
    tn = fp32_tile_n(cout)
    nt, nk = -(-cout // tn), -(-cin // FP32_CHUNK)
    assert tiles.shape == (nt, nk, FP32_CHUNK, 3, tn) and tiles.is_contiguous()
    assert tiles.dtype == torch.float32
    t, c, i, k, n = torch.meshgrid(*(torch.arange(s) for s in tiles.shape), indexing="ij")
    co, ci = tn * t + n, FP32_CHUNK * c + i
    want = torch.where((co < cout) & (ci < cin),
                       w[co.clamp(max=cout - 1), ci.clamp(max=cin - 1), k], 0.0)
    assert torch.equal(tiles, want)
    assert not tiles[-1, :, :, :, cout - (nt - 1) * tn:].any()  # the last tile's padding
    # bf16 weights are read exactly, as the wrapper rounds w to x's dtype
    wb = w.bfloat16()
    assert torch.equal(fp32_conv_tiles(wb), fp32_conv_tiles(wb.float()))


@pytest.mark.parametrize("b,cin,cout,l,g", CASES)
def test_fp32_kernel_walk_matches_jax(b, cin, cout, l, g):
    x, scale, bias, w, bb = _inputs(b, cin, cout, l)
    got = kernel_walk(*(torch.from_numpy(a) for a in (x, scale, bias, w, bb)), g).numpy()
    reference, pallas = _jax(b, cin, cout, l, g)
    atol = ATOL * (cin / 16) ** 0.5
    np.testing.assert_allclose(got, reference, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=atol)
    plain = fused_resblock.gn_silu_conv3_reference(
        *(torch.from_numpy(a) for a in (x, scale, bias, w, bb)), g).numpy()
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=atol)


def test_tile_geometry_fills_the_card_at_the_v1_shapes():
    """At batch 16 the v1 shapes give 128 blocks (0.97 of a wave of 132
    SMs at one block an SM), except (64, 64, 384) with 64 and (128, 128,
    768) with 256, as the source note lists."""
    blocks = {s: -(-s[2] // tile_positions(fp32_tile_n(s[1]))) * -(-s[1] // fp32_tile_n(s[1]))
              * 16 for s in V1_SHAPES}
    assert blocks == {s: {(64, 64, 384): 64, (128, 128, 768): 256}.get(s, 128)
                      for s in V1_SHAPES}
