"""K1's and K3's on-chip formulations, checked on the CPU before the card runs them.

The kernels cannot run here, so their decompositions are written out in
plain PyTorch, in the kernels' own order of operations, and held to the
JAX package in fp32 at rtol 1e-5 / atol 1e-6:

* K1's on-chip path (csrc/group_norm_silu.cu): one block per group holds
  it as 16-byte vectors (fp32: 4 elements, 512 threads; thread t holds
  vectors k * 512 + t), sums per thread, then a block reduction (a
  butterfly over each warp, then over the warps' sums); the mean; the
  same for the squared deviations; then y = (x - mean) * a_c + bias_c
  with a_c = rstd * scale_c, and SiLU as v / (1 + exp(-v)). Held to
  ``group_norm_silu_reference`` and the Pallas ``fused_group_norm_silu``
  (interpret mode).
* The streaming path's finalize: per 2048-element chunk a two-pass
  (count, mean, M2); one warp per group, lane l merging chunks l, l + 32,
  ... in order with Chan's formula, then lanes l and l + o for o = 16,
  8, 4, 2, 1. Held to the Pallas ``group_norm_silu_tiled`` (interpret
  mode, as tests/test_torch_port_backward.py runs it) and the reference.
* K3's row-sum route (csrc/group_norm_silu_bwd.cu): per (b, c) row the
  sums of dz and dz * xhat (per vector, then one warp per channel over
  its vectors; lane-strided elements where L % 4 != 0, the three-pass
  form), m1 and m2 from scale_c times the rows, dx from them, and dscale
  and dbias as the rows summed over the batch in 8 slices. Held to
  ``jax.vjp`` of the reference and to the Pallas kernel's VJP; dscale and
  dbias with atol scaled by sqrt(B L), as rounding of a B L-term fp32 sum
  grows with its square root (tests/test_torch_cuda_kernels.py does the
  same).

Inputs are made with numpy from a seed; JAX takes (B, L, C), the port
(B, C, L).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sleepgen.pallas_kernels import (fused_group_norm_silu, group_norm_silu_reference,
                                     group_norm_silu_tiled)
from sleepgen_torch.kernels.group_norm import ON_CHIP_MAX

VEC, THREADS = 4, 512  # fp32: 16-byte vectors, threads of an on-chip block
CHUNK, CHUNK_THREADS = 2048, 256  # the streaming path's chunks
RTOL, ATOL = 1e-5, 1e-6

# (B, C, L, G): the Pallas test shapes (tests/test_pallas_kernels.py:15, :26,
# :66), the largest stage-2 groups, an AEKL G = 1 shape and a ragged one
SHAPES = [(2, 16, 64, 1), (2, 16, 64, 4), (2, 16, 64, 16), (2, 8, 32, 4),
          (2, 32, 1024, 1), (2, 64, 512, 8), (2, 384, 768, 32), (2, 768, 384, 32),
          (2, 32, 3072, 1), (2, 24, 37, 8)]
ON_CHIP_SHAPES = [s for s in SHAPES if s[1] // s[3] * s[2] <= ON_CHIP_MAX]


def _inputs(b, c, l, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, c, l)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32)
    bias = (0.2 * rng.normal(size=c)).astype(np.float32)
    dy = rng.normal(size=(b, c, l)).astype(np.float32)
    return x, scale, bias, dy


def _blc(a: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(a.transpose(0, 2, 1))


def _bcl(a) -> np.ndarray:
    return np.asarray(a).transpose(0, 2, 1)


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """(..., 32) -> (...,): __shfl_xor_sync's butterfly, lane 0's value."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """(..., threads) -> (...,): gn_stats.cuh's block_sum."""
    warps = _warp_sum(v.reshape(*v.shape[:-1], -1, 32))
    return _warp_sum(F.pad(warps, (0, 32 - warps.shape[-1])))


def _thread_sums(v: torch.Tensor, threads: int, per_thread: int) -> torch.Tensor:
    """(R, n) -> (R, threads): thread t adds elements (k * threads + t) *
    per_thread + j for k, then j, in order (0 past n)."""
    r, n = v.shape
    span = threads * per_thread
    vecs = F.pad(v, (0, -n % span)).reshape(r, -1, threads, per_thread)
    s = torch.zeros(r, threads)
    for k in range(vecs.shape[1]):
        for j in range(per_thread):
            s = s + vecs[:, k, :, j]
    return s


def _two_pass(v: torch.Tensor, threads: int, per_thread: int):
    """(R, n) -> mean (R,), M2 (R,): the sum, then the squared deviations."""
    n = v.shape[1]
    mean = _block_sum(_thread_sums(v, threads, per_thread)) / n
    m2 = _block_sum(_thread_sums((v - mean[:, None]).square(), threads, per_thread))
    return mean, m2


def _silu(v: torch.Tensor) -> torch.Tensor:
    return v * torch.reciprocal(1.0 + torch.exp(-v))


def _apply(x, mean, rstd, scale, bias, g, silu):
    """(x - mean) * a_c + bias_c, a_c = rstd * scale_c, (+SiLU); x (B, C, L)."""
    b, c, l = x.shape
    a = (rstd.reshape(b, g, 1) * scale.reshape(g, -1)).reshape(b, c, 1)
    y = (x - mean.reshape(b, g, 1).repeat_interleave(c // g, 1)) * a + bias[:, None]
    return _silu(y) if silu else y


def k1_on_chip(x, scale, bias, g, eps=1e-6, silu=True):
    b, c, l = x.shape
    mean, m2 = _two_pass(x.reshape(b * g, -1), THREADS, VEC)
    rstd = torch.rsqrt(m2 / (c // g * l) + eps)
    return _apply(x, mean, rstd, scale, bias, g, silu), mean, rstd


def _chan(a, b):
    """Chan et al.'s merge of (count, mean, M2) states; an empty one is a no-op."""
    (na, ma, qa), (nb, mb, qb) = a, b
    nn = na + nb
    w = torch.where(nn > 0, nb / nn.clamp(min=1), torch.zeros_like(nn))
    d = mb - ma
    return nn, ma + d * w, qa + qb + d * d * na * w


def finalize(x, g, eps=1e-6):
    """The streaming path's statistics: chunk states, then one warp's
    fixed-order Chan merge; (mean, rstd) per group."""
    rows = x.reshape(x.shape[0] * g, -1)
    n = rows.shape[1]
    nchunks = -(-n // CHUNK)
    chunks = F.pad(rows, (0, nchunks * CHUNK - n)).reshape(-1, CHUNK)
    counts = torch.tensor([min(CHUNK, n - i * CHUNK) for i in range(nchunks)],
                          dtype=torch.float32).repeat(rows.shape[0])
    mean = _block_sum(_thread_sums(chunks, CHUNK_THREADS, CHUNK // CHUNK_THREADS)) / counts
    dev = (chunks - mean[:, None]).square()
    dev = dev * (torch.arange(CHUNK)[None, :] < counts[:, None])
    m2 = _block_sum(_thread_sums(dev, CHUNK_THREADS, CHUNK // CHUNK_THREADS))
    state = [t.reshape(-1, nchunks) for t in (counts, mean, m2)]
    lanes = [torch.zeros(rows.shape[0], 32) for _ in range(3)]
    for i in range(nchunks):  # lane i % 32 merges chunk i
        lane = [t[:, i % 32] for t in lanes]
        merged = _chan(lane, [t[:, i] for t in state])
        for t, m in zip(lanes, merged):
            t[:, i % 32] = m
    for o in (16, 8, 4, 2, 1):
        merged = _chan([t[:, :o] for t in lanes], [t[:, o:2 * o] for t in lanes])
        for t, m in zip(lanes, merged):
            t[:, :o] = m
    count, mean, m2 = (t[:, 0] for t in lanes)
    return mean, torch.rsqrt(m2 / count + eps)


def _row_sums(p1, p2, l):
    """Per (b, c) row: the sums of the per-element (or per-vector) terms
    p1, p2 (B, C, m) the way one warp per row adds them: lane-strided, then
    the butterfly."""
    b, c, m = p1.shape
    out = []
    for p in (p1, p2):
        lanes = F.pad(p, (0, -m % 32)).reshape(b, c, -1, 32)
        acc = torch.zeros(b, c, 32)
        for i in range(lanes.shape[2]):
            acc = acc + lanes[:, :, i]
        out.append(_warp_sum(acc))
    return out


def k3_row_sums(x, dy, scale, bias, mean, rstd, g, silu=True):
    """K3's route to (dx, dscale, dbias) through the per-(b, c) row sums."""
    b, c, l = x.shape
    cpg = c // g
    n = cpg * l
    mean_c = mean.reshape(b, g, 1).repeat_interleave(cpg, 1)
    rstd_c = rstd.reshape(b, g, 1).repeat_interleave(cpg, 1)
    xh = (x - mean_c) * rstd_c
    z = xh * scale[:, None] + bias[:, None]
    dz = dy
    if silu:
        s = torch.reciprocal(1.0 + torch.exp(-z))
        dz = dy * s * (1.0 + z * (1.0 - s))
    if l % VEC == 0:  # on chip: per-vector partials, one warp per channel
        p1, p2 = (t.reshape(b, c, l // VEC, VEC) for t in (dz, dz * xh))
        v1, v2 = torch.zeros(b, c, l // VEC), torch.zeros(b, c, l // VEC)
        for j in range(VEC):
            v1, v2 = v1 + p1[..., j], v2 + p2[..., j]
        r1, r2 = _row_sums(v1, v2, l)
        # warp w takes channels w, w + 16, ... (lane 0 adds scale_c * row),
        # then the block's sum over the warps' totals
        warps = THREADS // 32
        sc = scale.reshape(g, cpg)
        a1, a2 = torch.zeros(b, g, THREADS), torch.zeros(b, g, THREADS)
        for ch in range(cpg):
            w = (ch % warps) * 32
            a1[:, :, w] += sc[:, ch] * r1.reshape(b, g, cpg)[:, :, ch]
            a2[:, :, w] += sc[:, ch] * r2.reshape(b, g, cpg)[:, :, ch]
        m1, m2 = _block_sum(a1) / n, _block_sum(a2) / n
    else:  # three passes: lane-strided rows; thread t of 256 adds channels t, t + 256, ...
        r1, r2 = _row_sums(dz, dz * xh, l)
        sc = scale.reshape(1, g, cpg)
        t1, t2 = (F.pad(sc * r.reshape(b, g, cpg), (0, -cpg % 256)).reshape(b, g, -1, 256)
                  for r in (r1, r2))
        a1, a2 = torch.zeros(b, g, 256), torch.zeros(b, g, 256)
        for i in range(t1.shape[2]):
            a1, a2 = a1 + t1[:, :, i], a2 + t2[:, :, i]
        m1, m2 = _block_sum(a1) / n, _block_sum(a2) / n
    m1_c = m1.reshape(b, g, 1).repeat_interleave(cpg, 1)
    m2_c = m2.reshape(b, g, 1).repeat_interleave(cpg, 1)
    dx = rstd_c * (dz * scale[:, None] - m1_c - xh * m2_c)
    params = []
    for r in (r2, r1):  # dscale, dbias: 8 batch slices, each in order, then the slices
        slices = torch.zeros(8, c)
        for i in range(b):
            slices[i % 8] += r[i]
        total = torch.zeros(c)
        for k in range(8):
            total = total + slices[k]
        params.append(total)
    return dx, params[0], params[1]


@pytest.mark.parametrize("b,c,l,g", ON_CHIP_SHAPES)
@pytest.mark.parametrize("silu", [True, False])
def test_k1_on_chip_matches_jax(b, c, l, g, silu):
    x, scale, bias, _ = _inputs(b, c, l)
    y, mean, rstd = k1_on_chip(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), g, silu=silu)
    args = (_blc(x), jnp.asarray(scale), jnp.asarray(bias), g, 1e-6, silu)
    for want in (group_norm_silu_reference(*args), fused_group_norm_silu(*args)):
        np.testing.assert_allclose(y.numpy(), _bcl(want), rtol=RTOL, atol=ATOL)
    xg = x.astype(np.float64).reshape(b * g, -1)
    np.testing.assert_allclose(mean.numpy(), xg.mean(1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(xg.var(1) + 1e-6), rtol=RTOL)


@pytest.mark.parametrize("b,c,l,g", SHAPES)
def test_finalize_chan_tree_matches_tiled_pallas(b, c, l, g):
    x, scale, bias, _ = _inputs(b, c, l, seed=1)
    xt = torch.from_numpy(x)
    mean, rstd = finalize(xt, g)
    xg = x.astype(np.float64).reshape(b * g, -1)
    np.testing.assert_allclose(mean.numpy(), xg.mean(1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(xg.var(1) + 1e-6), rtol=RTOL)
    y = _apply(xt, mean, rstd, torch.from_numpy(scale), torch.from_numpy(bias), g, True)
    args = (_blc(x), jnp.asarray(scale), jnp.asarray(bias), g)
    for want in (group_norm_silu_tiled(*args, tile=512, interpret=True),
                 group_norm_silu_reference(*args)):
        np.testing.assert_allclose(y.numpy(), _bcl(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,c,l,g", SHAPES)
@pytest.mark.parametrize("silu", [True, False])
def test_k3_row_sums_match_jax_vjp(b, c, l, g, silu):
    x, scale, bias, dy = _inputs(b, c, l, seed=2)
    xt = torch.from_numpy(x)
    xg = xt.double().reshape(b * g, -1)
    mean = xg.mean(1).float()
    rstd = torch.rsqrt(xg.var(1, unbiased=False) + 1e-6).float()
    got = k3_row_sums(xt, torch.from_numpy(dy), torch.from_numpy(scale),
                      torch.from_numpy(bias), mean, rstd, g, silu)
    primals = (_blc(x), jnp.asarray(scale), jnp.asarray(bias))
    _, vjp = jax.vjp(lambda a, s, t: group_norm_silu_reference(a, s, t, g, 1e-6, silu),
                     *primals)
    want = vjp(_blc(dy))
    pallas = jax.grad(lambda a, s, t: jnp.sum(fused_group_norm_silu(a, s, t, g, 1e-6, silu)
                                              * _blc(dy)), argnums=(0, 1, 2))(*primals)
    for w in (want, pallas):
        np.testing.assert_allclose(got[0].numpy(), _bcl(w[0]), rtol=RTOL, atol=ATOL)
        for gv, wv in zip(got[1:], w[1:]):
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL,
                                       atol=ATOL * (b * l) ** 0.5)
