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
* K1's cluster form (csrc/gn_cluster.cuh), aligned groups of
  ON_CHIP_MAX < n <= CLUSTER_MAX: cs = ceil(n / ON_CHIP_MAX) blocks a
  group, block r holding the contiguous slice of ceil(n / (vec cs))
  vectors from vector r ceil(n / (vec cs)) on (the last slice shorter) in
  the on-chip layout; each block's thread and block sums as on chip, then
  the cs block sums added in rank order, for the sum and then for the
  squared deviations (exact two-pass statistics).
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
* K3's cluster form: the same slices; per-vector partials, then per
  channel row of each slice one warp over the row's vectors in the slice
  (lane-strided, then the butterfly), the slice's piece of the row; a row
  that straddles slices has its pieces added in rank order; each block's
  sums of scale_c * piece over its pieces, block sums, then the cs block
  sums in rank order, give m1 and m2.

The cluster cases run in both dtypes' layouts (fp32: 4-element vectors,
512 threads a block; bf16: 8 and 256) on inputs rounded to bf16, in fp32
arithmetic, so one JAX result serves both; every other case in the fp32
layout on fp32 inputs. Inputs are made with numpy from a seed; JAX takes
(B, L, C), the port (B, C, L).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sleepgen.pallas_kernels import (fused_group_norm_silu, group_norm_silu_reference,
                                     group_norm_silu_tiled)
from sleepgen_torch.kernels.group_norm import CLUSTER_MAX, ON_CHIP_MAX

# (elements in a 16-byte vector, threads of an on-chip or cluster block) by dtype
LAYOUTS = {"fp32": (4, 512), "bf16": (8, 256)}
VEC, THREADS = LAYOUTS["fp32"]
CHUNK, CHUNK_THREADS = 2048, 256  # the streaming path's chunks
RTOL, ATOL = 1e-5, 1e-6

# (B, C, L, G): the Pallas test shapes (tests/test_pallas_kernels.py:15, :26,
# :66), the largest stage-2 groups, an AEKL G = 1 shape and a ragged one
SHAPES = [(2, 16, 64, 1), (2, 16, 64, 4), (2, 16, 64, 16), (2, 8, 32, 4),
          (2, 32, 1024, 1), (2, 64, 512, 8), (2, 384, 768, 32), (2, 768, 384, 32),
          (2, 32, 3072, 1), (2, 24, 37, 8)]
ON_CHIP_SHAPES = [s for s in SHAPES if s[1] // s[3] * s[2] <= ON_CHIP_MAX]
# Cluster groups at batch 2, G 1: one row of ON_CHIP_MAX + 8 straddling
# two slices (cs 2); rows of 7000 cut by both slice boundaries (cs 3); one
# row over four slices (cs 4); the stage-1 step's (C, L) (aekl_eeg.yaml:
# cs 2, 4 and 8), among them the attention AEKL's (64, 768)
STRADDLING = [(2, 1, ON_CHIP_MAX + 8, 1), (2, 5, 7000, 1), (2, 1, 40000, 1)]
STAGE1 = [(2, 32, 768, 1), (2, 64, 768, 1), (2, 32, 1536, 1), (2, 32, 3072, 1),
          (2, 64, 1536, 1)]
CLUSTER_K1_SHAPES = STRADDLING + STAGE1
CLUSTER_K3_SHAPES = STRADDLING[:2] + [(2, 64, 768, 1)]


def _case(b, c, l, g, silu, layout=None):
    """A case of the tests below: an old one (layout None: fp32 layout and
    inputs, its id unchanged) or a cluster one in a dtype's layout."""
    tag = f"{silu}-{b}-{c}-{l}-{g}"
    return pytest.param(b, c, l, g, silu, layout or "fp32", layout is not None,
                        id=tag if layout is None else f"{layout}-{tag}")


def _inputs(b, c, l, seed=0, rounded=False):
    """x, scale, bias, dy; ``rounded``: x and dy rounded to bf16 (kept fp32)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, c, l)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.normal(size=c)).astype(np.float32)
    bias = (0.2 * rng.normal(size=c)).astype(np.float32)
    dy = rng.normal(size=(b, c, l)).astype(np.float32)
    if rounded:
        x, dy = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, dy))
    return x, scale, bias, dy


@functools.lru_cache(maxsize=None)
def _jax_forward(b, c, l, g, silu, seed, rounded):
    """(reference, Pallas in interpret mode) at the case's inputs, (B, C, L)."""
    x, scale, bias, _ = _inputs(b, c, l, seed, rounded)
    args = (_blc(x), jnp.asarray(scale), jnp.asarray(bias), g, 1e-6, silu)
    return tuple(_bcl(f(*args)) for f in (group_norm_silu_reference, fused_group_norm_silu))


@functools.lru_cache(maxsize=None)
def _jax_backward(b, c, l, g, silu, seed, rounded):
    """(jax.vjp of the reference, jax.grad through the Pallas kernel): each
    (dx (B, C, L), dscale, dbias)."""
    x, scale, bias, dy = _inputs(b, c, l, seed, rounded)
    primals = (_blc(x), jnp.asarray(scale), jnp.asarray(bias))
    _, vjp = jax.vjp(lambda a, s, t: group_norm_silu_reference(a, s, t, g, 1e-6, silu),
                     *primals)
    pallas = jax.grad(lambda a, s, t: jnp.sum(fused_group_norm_silu(a, s, t, g, 1e-6, silu)
                                              * _blc(dy)), argnums=(0, 1, 2))(*primals)
    return tuple((_bcl(w[0]), np.asarray(w[1]), np.asarray(w[2]))
                 for w in (vjp(_blc(dy)), pallas))


def k3_form(c, l, g, vec):
    """The form K3 takes (group_norm_silu_bwd.cu), as the card tests pin it."""
    n = c // g * l
    if l % vec:
        return "three_pass"
    return "on_chip" if n <= ON_CHIP_MAX else "cluster" if n <= CLUSTER_MAX else "three_pass"


def cluster_slices(n, vec):
    """[(first element, elements)] of each block of a group's cluster:
    ceil(nv / cs) vectors a block, the last slice shorter."""
    cs, nv = -(-n // ON_CHIP_MAX), n // vec
    per = -(-nv // cs)
    return [(r * per * vec, min(per, nv - r * per) * vec) for r in range(cs)]


def _rank_sum(parts):
    """The blocks' sums added in rank order, from 0, as every block does."""
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


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


def k1_on_chip(x, scale, bias, g, eps=1e-6, silu=True, layout="fp32"):
    vec, threads = LAYOUTS[layout]
    b, c, l = x.shape
    mean, m2 = _two_pass(x.reshape(b * g, -1), threads, vec)
    rstd = torch.rsqrt(m2 / (c // g * l) + eps)
    return _apply(x, mean, rstd, scale, bias, g, silu), mean, rstd


def k1_cluster(x, scale, bias, g, eps=1e-6, silu=True, layout="fp32"):
    """K1's cluster form: each block's slice summed as on chip, the block
    sums added in rank order; the same for the squared deviations."""
    vec, threads = LAYOUTS[layout]
    rows = x.reshape(x.shape[0] * g, -1)
    n = rows.shape[1]
    slices = [rows[:, e0:e0 + m] for e0, m in cluster_slices(n, vec)]
    mean = _rank_sum([_block_sum(_thread_sums(v, threads, vec)) for v in slices]) / n
    m2 = _rank_sum([_block_sum(_thread_sums((v - mean[:, None]).square(), threads, vec))
                    for v in slices])
    rstd = torch.rsqrt(m2 / n + eps)
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


def _lane_sum(v):
    """(..., m) -> (...,): one warp's sum of m terms, lane-strided, then the
    butterfly."""
    m = v.shape[-1]
    lanes = F.pad(v, (0, -m % 32)).reshape(*v.shape[:-1], -1, 32)
    acc = torch.zeros(*v.shape[:-1], 32)
    for i in range(lanes.shape[-2]):
        acc = acc + lanes[..., i, :]
    return _warp_sum(acc)


def _row_sums(p1, p2, l):
    """Per (b, c) row: the sums of the per-element (or per-vector) terms
    p1, p2 (B, C, m) the way one warp per row adds them: lane-strided, then
    the butterfly."""
    return [_lane_sum(p) for p in (p1, p2)]


def _dz(x, dy, scale, bias, mean, rstd, g, silu):
    """(dz, xhat), (B, C, L): the gradient at the affine output and xhat."""
    b, c, l = x.shape
    cpg = c // g
    mean_c = mean.reshape(b, g, 1).repeat_interleave(cpg, 1)
    rstd_c = rstd.reshape(b, g, 1).repeat_interleave(cpg, 1)
    xh = (x - mean_c) * rstd_c
    z = xh * scale[:, None] + bias[:, None]
    dz = dy
    if silu:
        s = torch.reciprocal(1.0 + torch.exp(-z))
        dz = dy * s * (1.0 + z * (1.0 - s))
    return dz, xh


def _vector_partials(t, vec):
    """(B, C, L) -> (B, C, L / vec): each vector's terms added in order."""
    p = t.reshape(*t.shape[:2], -1, vec)
    acc = torch.zeros(p.shape[:-1])
    for j in range(vec):
        acc = acc + p[..., j]
    return acc


def _dx_and_params(dz, xh, scale, rstd, m1, m2, r1, r2, g):
    """dx from m1 and m2 (B, G); dscale and dbias as the row sums r2 and r1
    (B, C) over the batch in 8 slices, each in order, then the slices."""
    b, c, _ = dz.shape
    cpg = c // g
    rstd_c, m1_c, m2_c = (t.reshape(b, g, 1).repeat_interleave(cpg, 1) for t in (rstd, m1, m2))
    dx = rstd_c * (dz * scale[:, None] - m1_c - xh * m2_c)
    params = []
    for r in (r2, r1):
        slices = torch.zeros(8, c)
        for i in range(b):
            slices[i % 8] += r[i]
        total = torch.zeros(c)
        for k in range(8):
            total = total + slices[k]
        params.append(total)
    return dx, params[0], params[1]


def k3_cluster(x, dy, scale, bias, mean, rstd, g, silu=True, layout="fp32"):
    """K3's cluster form: per-vector partials; per block and channel row of
    its slice one warp's sum of the row's vectors in the slice, its piece
    of the row (warp w of the block takes the slice's rows w, w + warps,
    ...); a whole row is its row sum, a straddling row's pieces are added
    in rank order by the block that holds its first element; lane 0 of
    each warp adds scale_c * piece over its pieces, a block sum, then the
    block sums in rank order give m1 and m2."""
    vec, threads = LAYOUTS[layout]
    b, c, l = x.shape
    cpg, warps = c // g, threads // 32
    n = cpg * l
    dz, xh = _dz(x, dy, scale, bias, mean, rstd, g, silu)
    v = [_vector_partials(t, vec).reshape(b * g, -1) for t in (dz, dz * xh)]
    sc = scale.reshape(1, g, cpg).expand(b, g, cpg).reshape(b * g, cpg)
    slices = cluster_slices(n, vec)
    pieces = {}  # (rank, row) -> the rank's (sum dz, sum dz * xhat) of the row
    for r, (e0, m) in enumerate(slices):
        for ch in range(e0 // l, (e0 + m - 1) // l + 1):
            lo, hi = max(ch * l, e0) // vec, min((ch + 1) * l, e0 + m) // vec
            pieces[r, ch] = [_lane_sum(t[:, lo:hi]) for t in v]
    rows = torch.zeros(2, b * g, cpg)
    block = []
    for r, (e0, m) in enumerate(slices):
        row0, last = e0 // l, (e0 + m - 1) // l
        lane0 = torch.zeros(2, b * g, threads)
        for ch in range(row0, last + 1):
            for i in range(2):
                lane0[i, :, (ch - row0) % warps * 32] += sc[:, ch] * pieces[r, ch][i]
            if ch * l >= e0 and (ch + 1) * l <= e0 + m:  # the whole row lies in the slice
                for i in range(2):
                    rows[i, :, ch] = pieces[r, ch][i]
        if last * l >= e0 and (last + 1) * l > e0 + m:  # starts here, runs on
            total = [p.clone() for p in pieces[r, last]]
            for q in range(r + 1, len(slices)):
                total = [t + p for t, p in zip(total, pieces[q, last])]
                if (last + 1) * l <= sum(slices[q]):
                    break
            for i in range(2):
                rows[i, :, last] = total[i]
        block.append(_block_sum(lane0))
    a = _rank_sum(block)
    r1, r2 = (t.reshape(b, c) for t in rows)
    return _dx_and_params(dz, xh, scale, rstd, a[0] / n, a[1] / n, r1, r2, g)


def k3_row_sums(x, dy, scale, bias, mean, rstd, g, silu=True, layout="fp32"):
    """K3's on-chip and three-pass routes to (dx, dscale, dbias) through
    the per-(b, c) row sums."""
    vec, threads = LAYOUTS[layout]
    b, c, l = x.shape
    cpg = c // g
    n = cpg * l
    dz, xh = _dz(x, dy, scale, bias, mean, rstd, g, silu)
    if k3_form(c, l, g, vec) == "on_chip":  # per-vector partials, one warp per channel
        v1, v2 = (_vector_partials(t, vec) for t in (dz, dz * xh))
        r1, r2 = _row_sums(v1, v2, l)
        # warp w takes channels w, w + warps, ... (lane 0 adds scale_c *
        # row), then the block's sum over the warps' totals
        warps = threads // 32
        sc = scale.reshape(g, cpg)
        a1, a2 = torch.zeros(b, g, threads), torch.zeros(b, g, threads)
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
    return _dx_and_params(dz, xh, scale, rstd, m1, m2, r1, r2, g)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: the suite runs several
    worker processes on the same cores, where each process's spinning
    thread pool slows every small op of the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [ON_CHIP_MAX + 8, 2 * ON_CHIP_MAX, 35000, 40000, CLUSTER_MAX - 8,
                               CLUSTER_MAX])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cluster_slices_cover_the_group(n, layout):
    """cs = ceil(n / ON_CHIP_MAX) slices, contiguous, whole vectors, none
    empty and none above ON_CHIP_MAX elements."""
    vec = LAYOUTS[layout][0]
    slices = cluster_slices(n, vec)
    assert len(slices) == -(-n // ON_CHIP_MAX) <= 8
    assert [e0 for e0, _ in slices] == [sum(m for _, m in slices[:r]) for r in range(len(slices))]
    assert sum(m for _, m in slices) == n
    assert all(0 < m <= ON_CHIP_MAX and m % vec == 0 and e0 % vec == 0 for e0, m in slices)


@pytest.mark.parametrize("b,c,l,g,silu,layout,rounded",
                         [_case(*s, silu) for s in ON_CHIP_SHAPES for silu in (True, False)]
                         + [_case(*s, True, layout) for s in CLUSTER_K1_SHAPES
                            for layout in LAYOUTS])
def test_k1_on_chip_matches_jax(b, c, l, g, silu, layout, rounded):
    """K1 held on chip: one block per group up to ON_CHIP_MAX elements, a
    cluster of blocks above, against the reference and the Pallas kernel."""
    x, scale, bias, _ = _inputs(b, c, l, rounded=rounded)
    k1 = k1_on_chip if c // g * l <= ON_CHIP_MAX else k1_cluster
    y, mean, rstd = k1(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), g,
                       silu=silu, layout=layout)
    for want in _jax_forward(b, c, l, g, silu, 0, rounded):
        np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)
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


@pytest.mark.parametrize("b,c,l,g,silu,layout,rounded",
                         [_case(*s, silu) for s in SHAPES for silu in (True, False)]
                         + [_case(*s, True, layout) for s in CLUSTER_K3_SHAPES
                            for layout in LAYOUTS])
def test_k3_row_sums_match_jax_vjp(b, c, l, g, silu, layout, rounded):
    """K3's route through the row sums in the form the group takes (on
    chip, cluster or three passes), against jax.vjp of the reference and
    the Pallas kernel's VJP."""
    x, scale, bias, dy = _inputs(b, c, l, seed=2, rounded=rounded)
    xt = torch.from_numpy(x)
    xg = xt.double().reshape(b * g, -1)
    mean = xg.mean(1).float()
    rstd = torch.rsqrt(xg.var(1, unbiased=False) + 1e-6).float()
    k3 = k3_cluster if k3_form(c, l, g, LAYOUTS[layout][0]) == "cluster" else k3_row_sums
    got = k3(xt, torch.from_numpy(dy), torch.from_numpy(scale), torch.from_numpy(bias), mean,
             rstd, g, silu, layout)
    for w in _jax_backward(b, c, l, g, silu, 2, rounded):
        np.testing.assert_allclose(got[0].numpy(), w[0], rtol=RTOL, atol=ATOL)
        for gv, wv in zip(got[1:], w[1:]):
            np.testing.assert_allclose(gv.numpy(), wv, rtol=RTOL, atol=ATOL * (b * l) ** 0.5)
