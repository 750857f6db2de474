"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit: they carry the
``cuda`` marker, and the ``cuda_card`` fixture skips them elsewhere. On
the H100 they run with
``python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py``
(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks). Tolerances: fp32 at the bounds of tests/test_pallas_kernels.py
(K1 rtol 1e-5 / atol 2e-6, K2 2e-4, K3 rtol 1e-4 / atol 1e-5, with the
atol of K3's dscale and dbias scaled by sqrt(B L), as rounding of a
B L-term fp32 sum grows with its square root), with TF32 off for the
plain version; bf16 against the plain version in fp32 on the same bf16
inputs, to bf16 output rounding (K2 also rounds h to bf16 before its
convolution).
"""
import copy

import numpy as np
import pytest
import torch

from sleepgen_torch.kernels import _build, adaln, attention, fused_resblock, group_norm
from sleepgen_torch.nn.layers import GroupNorm32
from sleepgen_torch.utils import profiling

pytestmark = [pytest.mark.cuda, pytest.mark.usefixtures("cuda_card")]

BF16_RTOL = 2.0**-8


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _count(name):
    return profiling.counters()[name]


def _form_counts():
    """K1's and K3's launches by form, {("K1", "on_chip"): n, ...}, those counted."""
    out = {}
    for name, n in profiling.counters().items():
        kid, sep, form = name.partition(".form.")
        if sep and n:
            out[kid.upper(), form] = n
    return out


def _inputs(seed, b, c, l, c_out=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, c, l)).astype(np.float32) + 0.5)
    scale = torch.from_numpy(1.0 + 0.2 * rng.normal(size=c).astype(np.float32))
    bias = torch.from_numpy(0.2 * rng.normal(size=c).astype(np.float32))
    out = [x.cuda(), scale.cuda(), bias.cuda()]
    if c_out is not None:
        w = (rng.normal(size=(c_out, c, 3)) / np.sqrt(3 * c)).astype(np.float32)
        bb = (0.1 * rng.normal(size=c_out)).astype(np.float32)
        out += [torch.from_numpy(w).cuda(), torch.from_numpy(bb).cuda()]
    return out


# Every distinct (C, L) that stage 2 gives K1 and K3 (sleepgen_torch/nn/unet1d.py
# at mc 128, channel_mult [1, 2, 4], latent length 768; G 32): groups of 1536
# to 9216 elements, all on the on-chip path
STAGE2_GN_SHAPES = [(128, 768), (128, 384), (256, 384), (256, 192), (512, 192), (1024, 192),
                    (768, 192), (512, 384), (768, 384), (384, 384), (384, 768), (256, 768)]
# ... at batch 2; then groups of ON_CHIP_MAX and ON_CHIP_MAX + 8 elements
# (G 1), on each side of the switch to the streaming path; L 130, not a
# multiple of a 16-byte vector
GN_CASES = ([(2, c, l, 32) for c, l in STAGE2_GN_SHAPES]
            + [(2, 16, group_norm.ON_CHIP_MAX // 16, 1), (2, 1, group_norm.ON_CHIP_MAX + 8, 1),
               (3, 48, 130, 8)])


@pytest.mark.parametrize("b,c,l,g", [(2, 16, 64, 4), (3, 64, 768, 1),
                                     (4, 128, 768, 32), (2, 24, 37, 8),
                                     (2, 32, 3072, 1)] + GN_CASES)
@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_silu_kernel_fp32(b, c, l, g, apply_silu):
    x, scale, bias = _inputs(0, b, c, l)
    got = group_norm.group_norm_silu(x, scale, bias, g, 1e-6, apply_silu)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x, scale, bias, g, 1e-6, apply_silu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("b,c,l,g", [(4, 128, 768, 32), (2, 32, 3072, 1), (2, 24, 37, 8)]
                         + GN_CASES)
def test_group_norm_silu_kernel_bf16(b, c, l, g):
    x, scale, bias = _inputs(1, b, c, l)
    xb = x.bfloat16()
    got = group_norm.group_norm_silu(xb, scale, bias, g)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(xb.float(), scale, bias, g)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    assert bool((err <= BF16_RTOL * want.abs() + 1e-5).all()), err.max()


# Every distinct (C_in, C_out, L) that the sampler gives K2
# (sleepgen_torch/nn/unet1d.py:118-147 at mc 128, channel_mult [1, 2, 4],
# latent length 768; G 32): C_in 128-1024, C_out 128/256/512, L 768/384/192.
SAMPLER_K2_SHAPES = [
    (128, 128, 768), (128, 128, 384), (128, 256, 384), (256, 256, 384), (256, 256, 192),
    (256, 512, 192), (512, 512, 192), (1024, 512, 192), (768, 512, 192), (512, 512, 384),
    (768, 256, 384), (512, 256, 384), (384, 256, 384), (256, 256, 768), (384, 128, 768),
    (256, 128, 768)]
# C_in not a multiple of the 64-channel chunk; L shorter than one tile; L
# not a multiple of either tile's positions
EDGE_K2_SHAPES = [(96, 128, 384), (96, 256, 192), (128, 256, 8), (128, 128, 8),
                  (256, 128, 1000), (256, 512, 1000)]


# ... at batch 2, G 32, beside the older cases below
K2_CASES = [(2, cin, cout, l, 32) for cin, cout, l in SAMPLER_K2_SHAPES + EDGE_K2_SHAPES]


@pytest.mark.parametrize("b,cin,cout,l,g", [(2, 16, 16, 64, 8), (2, 32, 64, 96, 32),
                                            (3, 128, 256, 384, 32), (2, 24, 40, 37, 4)]
                         + K2_CASES)
def test_gn_silu_conv3_kernel_fp32(b, cin, cout, l, g):
    x, scale, bias, w, bb = _inputs(2, b, cin, l, cout)
    got = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, g)
    torch.cuda.synchronize()
    want = fused_resblock.gn_silu_conv3_reference(x, scale, bias, w, bb, g)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,cin,cout,l,g", [(2, 24, 40, 37, 4), (3, 48, 136, 130, 8),
                                            (2, 16, 16, 64, 8)] + K2_CASES)
def test_gn_silu_conv3_kernel_bf16(b, cin, cout, l, g):
    x, scale, bias, w, bb = _inputs(3, b, cin, l, cout)
    xb, wb, bbb = x.bfloat16(), w.bfloat16(), bb.bfloat16()
    got = fused_resblock.gn_silu_conv3(xb, scale, bias, wb, bbb, g)
    torch.cuda.synchronize()
    want = fused_resblock.gn_silu_conv3_reference(xb.float(), scale, bias, wb.float(),
                                                  bbb.float(), g)
    err = (got.float() - want).abs()
    tol = BF16_RTOL * want.abs() + 4 * BF16_RTOL * want.square().mean().sqrt()
    assert bool((err <= tol).all()), err.max()


# A guided sampler runs the UNet on the conditional and the null batch in
# one forward: batch 128 at the service's batch 64. K1 at every UNet
# GroupNorm shape, K2 at every sampler shape, fp32 and bf16.
GUIDED_BATCH = 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,l", STAGE2_GN_SHAPES)
def test_group_norm_silu_kernel_at_the_guided_batch(c, l, dtype):
    x, scale, bias = _inputs(21, GUIDED_BATCH, c, l)
    x = x.to(dtype)
    got = group_norm.group_norm_silu(x, scale, bias, 32)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x.float(), scale, bias, 32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
    else:
        err = (got.float() - want).abs()
        assert bool((err <= BF16_RTOL * want.abs() + 1e-5).all()), err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,l", SAMPLER_K2_SHAPES)
def test_gn_silu_conv3_kernel_at_the_guided_batch(cin, cout, l, dtype):
    x, scale, bias, w, bb = _inputs(22, GUIDED_BATCH, cin, l, cout)
    x, w, bb = x.to(dtype), w.to(dtype), bb.to(dtype)
    got = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
    torch.cuda.synchronize()
    want = fused_resblock.gn_silu_conv3_reference(x.float(), scale, bias, w.float(),
                                                  bb.float(), 32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        err = (got.float() - want).abs()
        tol = BF16_RTOL * want.abs() + 4 * BF16_RTOL * want.square().mean().sqrt()
        assert bool((err <= tol).all()), err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gn_silu_conv3_is_deterministic(dtype):
    x, scale, bias, w, bb = _inputs(13, 4, 512, 192, 512)
    x, w, bb = x.to(dtype), w.to(dtype), bb.to(dtype)
    a = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
    b = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gn_silu_conv3_sees_weight_updates(dtype):
    """Each path caches each weight's re-layout; an in-place update of the
    weight, or a new weight, must not reuse it."""
    x, scale, bias, w, _ = _inputs(14, 2, 64, 96, 128)
    x, w = x.to(dtype), w.to(dtype)
    bb = torch.zeros(128, dtype=dtype, device="cuda")
    before = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 8)
    with torch.no_grad():
        w.neg_()  # with a zero bias, y changes sign exactly
    after = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 8)
    fresh = fused_resblock.gn_silu_conv3(x, scale, bias, w.clone(), bb, 8)
    assert torch.equal(after, -before)
    assert torch.equal(after, fresh)


def test_gn_silu_conv3_takes_fp32_master_weights():
    """Under autocast the UNet passes its fp32 master weight to the bf16
    path: the result is that of the weight rounded to bf16, and the
    re-layout is made once per weight and version, inference mode or not."""
    x, scale, bias, w, bb = _inputs(15, 2, 64, 96, 128)
    x, bb = x.bfloat16(), bb.bfloat16()
    want = fused_resblock.gn_silu_conv3(x, scale, bias, w.bfloat16(), bb, 8)
    profiling.reset()
    with torch.inference_mode():
        got = [fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 8) for _ in range(3)]
    assert all(torch.equal(g, want) for g in got)
    assert _count("k2.relayouts") == 1
    with torch.no_grad():
        w.mul_(0.5)
    fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 8)
    assert _count("k2.relayouts") == 2


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_gn_silu_conv3_lays_out_fp32_weights_once(mode):
    """The fp32 path reads the weight as fp32_conv_tiles, made once per
    weight and version: a 1000-step ancestral chain re-lays out each of its
    weights once, not at every launch."""
    x, scale, bias, w, bb = _inputs(16, 2, 64, 96, 128)
    want = fused_resblock.gn_silu_conv3_reference(x, scale, bias, w, bb, 8)
    profiling.reset()
    with getattr(torch, mode)():
        got = [fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 8) for _ in range(3)]
    torch.testing.assert_close(got[0], want, rtol=2e-4, atol=2e-4)
    assert all(torch.equal(g, got[0]) for g in got)
    assert _count("k2.relayouts") == 1 and _count("k2.launches") == 3
    with torch.no_grad():
        w.mul_(0.5)
    with getattr(torch, mode)():
        fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 8)
    assert _count("k2.relayouts") == 2


# The fp32 tile's edges (TN 64 for C_out <= 64, else 128; TL 96 or 48;
# chunks of 32 input channels): C_out 40, 136, 192; L 8, 37, 130, 1000
# (37 and 130 not a whole number of 16-byte vectors: element copies);
# C_in 24 and 96; G 4 to 64; batch 1 and 16; (B, C_in, C_out, L, G, x's
# offset in floats from an aligned base: 1 forces element copies at L 96)
FP32_EDGE_CASES = [(1, 24, 40, 37, 4, 0), (16, 96, 136, 130, 8, 0), (1, 96, 192, 1000, 32, 0),
                   (16, 24, 40, 8, 4, 0), (1, 64, 192, 8, 64, 0), (16, 128, 40, 1000, 64, 0),
                   (1, 96, 136, 37, 16, 0), (16, 96, 192, 130, 32, 0), (1, 24, 136, 1000, 8, 0),
                   (16, 64, 64, 96, 32, 1)]


def _hold_k2_bf16(got, want):
    """K2's bf16 tolerance: |err| <= 2^-8 |ref| + 2^-6 rms(ref)."""
    err = (got.float() - want).abs()
    tol = BF16_RTOL * want.abs() + 4 * BF16_RTOL * want.square().mean().sqrt()
    assert bool((err <= tol).all()), err.max()


def _k2_bf16(seed, b, cin, cout, l, g=32):
    """K2's bf16 output at the shape, and the plain version's in fp32 on the same inputs."""
    x, scale, bias, w, bb = _inputs(seed, b, cin, l, cout)
    xb, wb, bbb = x.bfloat16(), w.bfloat16(), bb.bfloat16()
    got = fused_resblock.gn_silu_conv3(xb, scale, bias, wb, bbb, g)
    torch.cuda.synchronize()
    return got, fused_resblock.gn_silu_conv3_reference(xb.float(), scale, bias, wb.float(),
                                                       bbb.float(), g)


# The sampling cells' batch: 64 windows, every tile of a launch in flight
# on the persistent grid (256 tiles at the LDM's shapes, 132 SMs)
SAMPLER_BATCH = 64
# The DM's chains: the sampler's (C_in, C_out) at L 3072, 1536 and 768
DM_K2_SHAPES = sorted({(cin, cout, 4 * l) for cin, cout, l in SAMPLER_K2_SHAPES})


@pytest.mark.parametrize("cin,cout,l", SAMPLER_K2_SHAPES)
def test_gn_silu_conv3_bf16_at_the_sampler_batch(cin, cout, l):
    _hold_k2_bf16(*_k2_bf16(23, SAMPLER_BATCH, cin, cout, l))


@pytest.mark.parametrize("cin,cout,l", DM_K2_SHAPES)
def test_gn_silu_conv3_bf16_at_the_dm_shapes(cin, cout, l):
    _hold_k2_bf16(*_k2_bf16(24, 8, cin, cout, l))


@pytest.mark.parametrize("cin,cout,l", [(512, 512, 192), (128, 128, 768), (96, 256, 1002)])
def test_gn_silu_conv3_bf16_graph_replay_is_the_eager_result(cin, cout, l):
    """A CUDA graph captured over K2 (the statistics, then the tiles as their
    programmatic dependent) replays the eager launch bit for bit."""
    x, scale, bias, w, bb = _inputs(25, 8, cin, l, cout)
    x, w, bb = x.bfloat16(), w.bfloat16(), bb.bfloat16()
    with torch.no_grad():
        eager = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
        x.copy_(x.flip(0))  # new inputs in the captured buffer, then back
        graph.replay()
        flipped = out.clone()
        x.copy_(x.flip(0))
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), eager.view(torch.int16))
    assert torch.equal(flipped.view(torch.int16), eager.flip(0).view(torch.int16))


def test_gn_silu_conv3_counts_its_load_form():
    """K2's bf16 launches count how x reached the tiles: the tensor map at
    the sampler's shapes, element loads where L % 8 != 0 or x is not 16-byte
    aligned; an fp32 launch counts no form."""
    profiling.reset()
    for cin, cout, l in SAMPLER_K2_SHAPES:
        _k2_bf16(26, 2, cin, cout, l)
    assert _count("k2.form.tma") == len(SAMPLER_K2_SHAPES) and _count("k2.form.elem") == 0
    profiling.reset()
    got, want = _k2_bf16(27, 2, 256, 128, 1002)
    _hold_k2_bf16(got, want)
    x, scale, bias, w, bb = _inputs(28, 2, 128, 384, 128)
    buf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    buf[1:].copy_(x.flatten())
    xs = buf[1:].view(x.shape)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    got = fused_resblock.gn_silu_conv3(xs, scale, bias, w.bfloat16(), bb.bfloat16(), 32)
    _hold_k2_bf16(got, fused_resblock.gn_silu_conv3_reference(
        xs.float(), scale, bias, w.bfloat16().float(), bb.bfloat16().float(), 32))
    fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)  # fp32
    torch.cuda.synchronize()
    assert (_count("k2.form.tma"), _count("k2.form.elem"), _count("k2.launches")) == (0, 2, 3)


@pytest.mark.parametrize("b,cin,cout,l,g,offset", FP32_EDGE_CASES)
def test_gn_silu_conv3_fp32_at_the_tile_edges(b, cin, cout, l, g, offset):
    x, scale, bias, w, bb = _inputs(17, b, cin, l, cout)
    if offset:
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    got = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, g)
    again = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, g)
    torch.cuda.synchronize()
    want = fused_resblock.gn_silu_conv3_reference(x, scale, bias, w, bb, g)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_wrappers_reject_bad_inputs():
    x, scale, bias, w, bb = _inputs(4, 2, 16, 32, 16)
    with pytest.raises(ValueError):
        group_norm.group_norm_silu(x.transpose(1, 2), scale, bias, 4)
    with pytest.raises(ValueError):
        group_norm.group_norm_silu(x, scale.double(), bias, 4)
    with pytest.raises(ValueError):
        fused_resblock.gn_silu_conv3(x, scale, bias, w.double(), bb, 4)
    with pytest.raises(ValueError):
        fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 3)


def test_launch_counters_count_kernel_launches():
    profiling.reset()
    x, scale, bias, w, bb = _inputs(5, 2, 16, 32, 16)
    group_norm.group_norm_silu(x, scale, bias, 4)
    fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 4)
    fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 4)
    group_norm.group_norm_silu(x.cpu(), scale.cpu(), bias.cpu(), 4)  # plain: not counted
    xg = x.clone().requires_grad_()
    group_norm.group_norm_silu(xg, scale, bias, 4).sum().backward()
    assert _count("k1.launches") == 2
    assert _count("k3.launches") == 1
    assert profiling.keyed("k3.launch_shapes")[(2, 16, 32, 4, True, "torch.float32")] == 1
    assert _form_counts() == {("K1", "on_chip"): 2, ("K3", "on_chip"): 1}
    assert _count("k2.launches") == 2
    assert profiling.keyed("k2.launch_shapes")[(2, 16, 16, 32, 4, "torch.float32")] == 2


def _backward_case(seed, b, c, l, g, apply_silu, dtype):
    x, scale, bias = _inputs(seed, b, c, l)
    x = x.to(dtype)
    dy = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(b, c, l)).astype(
        np.float32)).cuda().to(dtype)
    stats = group_norm.group_norm_silu_forward(x, scale, bias, g, 1e-6, apply_silu)[1]
    got = group_norm.group_norm_silu_backward(x, dy, scale, bias, stats, g, apply_silu)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_backward_reference(x.float(), dy.float(), scale, bias,
                                                         stats, g, apply_silu)
    torch.testing.assert_close(stats, group_norm.group_stats_reference(x, g), rtol=1e-5,
                               atol=2e-6)
    for name, gv, wv in zip(("dscale", "dbias"), got[1:], want[1:]):
        torch.testing.assert_close(gv, wv, rtol=1e-4, atol=1e-5 * (b * l) ** 0.5, msg=name)
    return got[0], want[0]


@pytest.mark.parametrize("b,c,l,g", [(2, 16, 64, 4), (3, 64, 768, 1), (4, 128, 768, 32),
                                     (2, 24, 37, 8), (2, 32, 3072, 1), (5, 1024, 192, 32)]
                         + GN_CASES)
@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_backward_kernel_fp32(b, c, l, g, apply_silu):
    dx, want = _backward_case(6, b, c, l, g, apply_silu, torch.float32)
    torch.testing.assert_close(dx, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,c,l,g", [(4, 128, 768, 32), (2, 32, 3072, 1), (3, 768, 192, 32),
                                     (2, 24, 37, 8)] + GN_CASES)
def test_group_norm_backward_kernel_bf16(b, c, l, g):
    dx, want = _backward_case(7, b, c, l, g, True, torch.bfloat16)
    assert dx.dtype == torch.bfloat16
    err = (dx.float() - want).abs()
    assert bool((err <= BF16_RTOL * want.abs() + 1e-5).all()), err.max()


def test_group_norm_backward_is_deterministic():
    x, scale, bias = _inputs(8, 8, 256, 384)
    dy = torch.randn_like(x)
    stats = group_norm.group_norm_silu_forward(x, scale, bias, 32)[1]
    a = group_norm.group_norm_silu_backward(x, dy, scale, bias, stats, 32)
    b = group_norm.group_norm_silu_backward(x, dy, scale, bias, stats, 32)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,c,l,g", [(8, 768, 384, 32), (2, 32, 3072, 1)])
def test_group_norm_silu_is_deterministic(dtype, b, c, l, g):
    """Two launches give equal bits, y and stats, on the on-chip path and
    on the streaming one."""
    x, scale, bias = _inputs(16, b, c, l)
    x = x.to(dtype)
    y1, s1 = group_norm.group_norm_silu_forward(x, scale, bias, g)
    y2, s2 = group_norm.group_norm_silu_forward(x, scale, bias, g)
    assert torch.equal(y1.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       y2.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))


def _scratch_floats(b, c, l, g, dtype=torch.float32):
    """K1's scratch for x (b, c, l) into a fresh y: 0 unless the group streams."""
    x = torch.empty((b, c, l), dtype=dtype, device="cuda")
    return _build.load().sg_group_norm_silu_scratch_floats(
        x.data_ptr(), torch.empty_like(x).data_ptr(), b, c, l, g, group_norm.DTYPE_CODES[dtype])


def _forms(b, c, l, g, dtype=torch.float32):
    """{kernel: the form it took} for one K1 and one K3 launch at the shape."""
    x, scale, bias = _inputs(40, b, c, l)
    x = x.to(dtype)
    profiling.reset()
    y, stats = group_norm.group_norm_silu_forward(x, scale, bias, g)
    group_norm.group_norm_silu_backward(x, torch.ones_like(y), scale, bias, stats, g)
    torch.cuda.synchronize()
    return {kid: form for kid, form in _form_counts()}


def test_group_norm_path_switch_at_on_chip_max():
    """A group of ON_CHIP_MAX elements takes the on-chip path, one of
    ON_CHIP_MAX + 8 the cluster form (neither needs scratch), one of
    CLUSTER_MAX the cluster form and one of CLUSTER_MAX + 8 the streaming
    path and the three-pass form."""
    n, top = group_norm.ON_CHIP_MAX, group_norm.CLUSTER_MAX
    assert _scratch_floats(2, 16, n // 16, 1) == 0
    assert _forms(2, 16, n // 16, 1) == {"K1": "on_chip", "K3": "on_chip"}
    assert _scratch_floats(2, 1, n + 8, 1) == 0
    assert _forms(2, 1, n + 8, 1) == {"K1": "cluster", "K3": "cluster"}
    assert _forms(2, 32, top // 32, 1) == {"K1": "cluster", "K3": "cluster"}
    assert _scratch_floats(2, 1, top + 8, 1) > 0
    assert _forms(2, 1, top + 8, 1) == {"K1": "streaming", "K3": "three_pass"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_group_norm_kernels_take_unaligned_bases(dtype):
    """x, dy and the outputs on bases that are not 16-byte aligned (a view
    one element into its storage): element loads, same results."""
    b, c, l, g = 2, 64, 192, 32
    x, scale, bias = _inputs(17, b, c, l)
    dy = torch.randn_like(x)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device="cuda")
        buf[1:].copy_(t.flatten())
        return buf[1:].view(b, c, l)

    xs, dys = shifted(x), shifted(dy)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    y, stats = group_norm.group_norm_silu_forward(xs, scale, bias, g)
    got = group_norm.group_norm_silu_backward(xs, dys, scale, bias, stats, g)
    torch.cuda.synchronize()
    xf, dyf = xs.float(), dys.float()
    want_y = group_norm.group_norm_silu_reference(xf, scale, bias, g)
    want = group_norm.group_norm_silu_backward_reference(xf, dyf, scale, bias, stats, g)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want_y, rtol=1e-5, atol=2e-6)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    else:
        for gv, wv in ((y, want_y), (got[0], want[0])):
            err = (gv.float() - wv).abs()
            assert bool((err <= BF16_RTOL * wv.abs() + 1e-5).all()), err.max()
    for gv, wv in zip(got[1:], want[1:]):
        torch.testing.assert_close(gv, wv, rtol=1e-4, atol=1e-5 * (b * l) ** 0.5)


def test_group_norm32_gradients_on_cuda_equal_plain():
    """GroupNorm32 (K1 forward, K3 backward) on the card against the same
    module on the CPU (plain versions), with a strided output gradient."""
    x, scale, bias = _inputs(9, 3, 64, 96)
    grads = {}
    for dev in ("cuda", "cpu"):
        m = GroupNorm32(64, 8, fuse_silu=True).to(dev)
        with torch.no_grad():
            m.weight.copy_(scale)
            m.bias.copy_(bias)
        xd = x.detach().to(dev).requires_grad_()
        dy = torch.linspace(-1, 1, 3 * 96 * 64, device=dev).reshape(3, 96, 64).transpose(1, 2)
        m(xd).backward(dy)  # dy is not contiguous
        grads[dev] = [t.grad.cpu() for t in (xd, m.weight, m.bias)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * (3 * 96) ** 0.5)


def test_gn_silu_conv3_raises_under_grad():
    x, scale, bias, w, bb = _inputs(10, 2, 16, 32, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_resblock.gn_silu_conv3(x, scale, bias, w.requires_grad_(), bb, 4)
    with torch.no_grad():
        fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 4)
    assert fused_resblock.fused_gn_silu_conv3 is fused_resblock.gn_silu_conv3


def test_group_norm_tiled_long_window():
    """B2's long window (16, 32, 49152, G 1), through K1."""
    x, scale, bias = _inputs(11, 16, 32, 49152)
    got = group_norm.group_norm_silu_tiled(x, scale, bias, 1)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x, scale, bias, 1)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# The signal-space DM's GroupNorm groups (sleepgen/configs/dm.yaml: mc 128,
# channel_mult [1, 2, 4], L 3072; G 32): the encoder's are exactly
# ON_CHIP_MAX (12,288) elements, the largest on-chip case; the decoder's
# skip concatenations give G 32 groups of 18,432-36,864, the cluster form
# of K1 and K3
DM_ON_CHIP = [(128, 3072), (256, 1536), (512, 768)]
DM_CLUSTER = [(256, 3072), (384, 3072), (384, 1536), (768, 1536)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,l", DM_ON_CHIP + DM_CLUSTER)
def test_group_norm_kernels_at_the_dm_groups(c, l, dtype):
    """K1 and K3 at batch 4 against their plain versions, each group in the
    form its size picks: on chip at 12,288 elements, the cluster above; no
    scratch either way."""
    b, g = 4, 32
    assert _scratch_floats(b, c, l, g, dtype) == 0
    form = "on_chip" if (c, l) in DM_ON_CHIP else "cluster"
    assert _forms(b, c, l, g, dtype) == {"K1": form, "K3": form}
    assert (c // g * l == group_norm.ON_CHIP_MAX) == ((c, l) in DM_ON_CHIP)
    x, scale, bias = _inputs(18, b, c, l)
    x = x.to(dtype)
    got = group_norm.group_norm_silu(x, scale, bias, g)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x.float(), scale, bias, g)
    dx, dx_want = _backward_case(19, b, c, l, g, True, dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
        torch.testing.assert_close(dx, dx_want, rtol=1e-4, atol=1e-5)
    else:
        for out, ref in ((got, want), (dx, dx_want)):
            err = (out.float() - ref).abs()
            assert bool((err <= BF16_RTOL * ref.abs() + 1e-5).all()), err.max()


# band-eval's reconstruction: the AEKL of aekl_eeg.yaml ([32, 32, 64], G 1)
# reconstructs its --max_windows 512 test windows (L 3072) in one call.
# Each (C, L, SiLU) K1 gets there, 26 launches in all; groups of 24,576 to
# 98,304 elements, the cluster form (the stage-1 step's shapes too)
BAND_EVAL_BATCH = 512
RECON_GN_SHAPES = [(32, 3072, True), (32, 1536, True), (32, 768, True), (64, 768, True),
                   (64, 768, False), (64, 1536, True), (32, 3072, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,l,silu", RECON_GN_SHAPES)
def test_group_norm_silu_kernel_at_the_band_eval_batch(c, l, silu, dtype):
    x, scale, bias = _inputs(23, BAND_EVAL_BATCH, c, l)
    x = x.to(dtype)
    got = group_norm.group_norm_silu(x, scale, bias, 1, 1e-6, silu)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x.float(), scale, bias, 1, 1e-6, silu)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
    else:
        err = (got.float() - want).abs()
        assert bool((err <= BF16_RTOL * want.abs() + 1e-5).all()), err.max()


# The first-generation VAE's GroupNorms (sleepgen_torch/nn/aekl_v1.py at the
# trainers' defaults: n_channels 64, ch_mult (1, 2, 4), G 32, L 3072), fp32 as
# the v1 trainers run them: (C, L, SiLU), groups of 3,072 to 12,288
# elements, all on chip; the decoder's first resblock after each upsample,
# (256, 1536) and (128, 3072), reaches exactly ON_CHIP_MAX.
V1_BATCH = 16
V1_AEKL_GN_SHAPES = [(64, 3072, True), (64, 1536, True), (128, 1536, True), (128, 768, True),
                     (256, 768, True), (256, 768, False), (256, 1536, True), (128, 3072, True),
                     (64, 3072, False)]


def _hold(got, want, dtype, rtol, atol):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    else:
        err = (got.float() - want).abs()
        assert bool((err <= BF16_RTOL * want.abs() + 1e-5).all()), err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,l,silu", V1_AEKL_GN_SHAPES)
def test_group_norm_kernels_at_the_v1_aekl_groups(c, l, silu, dtype):
    """K1 and K3 at batch 16, G 32, each group on chip (no scratch)."""
    g = 32
    assert _scratch_floats(V1_BATCH, c, l, g, dtype) == 0
    assert c // g * l <= group_norm.ON_CHIP_MAX
    x, scale, bias = _inputs(24, V1_BATCH, c, l)
    x = x.to(dtype)
    got = group_norm.group_norm_silu(x, scale, bias, g, 1e-6, silu)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x.float(), scale, bias, g, 1e-6, silu)
    _hold(got, want, dtype, 1e-5, 2e-6)
    dx, dx_want = _backward_case(25, V1_BATCH, c, l, g, silu, dtype)
    _hold(dx, dx_want, dtype, 1e-4, 1e-5)


# Every (C_in, C_out, L) that the v1 ancestral sampler gives K2: the DDPM's
# UNet (mc 64, channel_mult (1, 2), attention at ds 2, G 32) on the v1
# latent of 768 x 3, batch 16, fp32 (K2's FMA path): C_out 64 fills half of
# K2's 128-wide output tile.
V1_UNET_K2_SHAPES = [(64, 64, 768), (64, 64, 384), (64, 128, 384), (128, 128, 384),
                     (256, 128, 384), (192, 128, 384), (128, 128, 768), (192, 64, 768),
                     (128, 64, 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,l", V1_UNET_K2_SHAPES)
def test_gn_silu_conv3_kernel_at_the_v1_unet(cin, cout, l, dtype):
    x, scale, bias, w, bb = _inputs(26, V1_BATCH, cin, l, cout)
    x, w, bb = x.to(dtype), w.to(dtype), bb.to(dtype)
    got = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
    torch.cuda.synchronize()
    want = fused_resblock.gn_silu_conv3_reference(x.float(), scale, bias, w.float(),
                                                  bb.float(), 32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        err = (got.float() - want).abs()
        tol = BF16_RTOL * want.abs() + 4 * BF16_RTOL * want.square().mean().sqrt()
        assert bool((err <= tol).all()), err.max()


# The long window (benches/long_window.py: the default UNet at window 12288,
# batch 16): K1 takes groups of 49,152 elements at G 32 (C 128 at L 12288),
# the cluster form, and here also C 256 and 384 at L 12288 (98,304
# elements, the cluster form; 147,456, the streaming path); K2 runs at
# L 12288 (its first level and the skip concatenations of the last).
LONG_K1_SHAPES = [(128, 12288), (256, 12288), (384, 12288)]
LONG_K2_SHAPES = [(128, 128, 12288), (256, 128, 12288), (384, 128, 12288)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,l", LONG_K1_SHAPES)
def test_group_norm_silu_kernel_at_the_long_window(c, l, dtype):
    x, scale, bias = _inputs(27, V1_BATCH, c, l)
    assert c // 32 * l > group_norm.ON_CHIP_MAX  # the cluster form or the streaming path
    x = x.to(dtype)
    got = group_norm.group_norm_silu(x, scale, bias, 32)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x.float(), scale, bias, 32)
    _hold(got, want, dtype, 1e-5, 2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,l", LONG_K2_SHAPES)
def test_gn_silu_conv3_kernel_at_the_long_window(cin, cout, l, dtype):
    x, scale, bias, w, bb = _inputs(28, V1_BATCH, cin, l, cout)
    x, w, bb = x.to(dtype), w.to(dtype), bb.to(dtype)
    got = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
    torch.cuda.synchronize()
    want = fused_resblock.gn_silu_conv3_reference(x.float(), scale, bias, w.float(),
                                                  bb.float(), 32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        err = (got.float() - want).abs()
        tol = BF16_RTOL * want.abs() + 4 * BF16_RTOL * want.square().mean().sqrt()
        assert bool((err <= tol).all()), err.max()


# The options UNet (ldm.yaml with use_scale_shift_norm, resblock_updown
# False; sampler batch 64): chain 2 of every resblock is K1 without SiLU
# at each level's (C, L), G 32; chain 1 of every resblock runs K2, the
# resampling now outside the resblocks.
OPT_K1_SHAPES = [(128, 768), (256, 384), (512, 192)]
OPT_K2_SHAPES = [(128, 128, 768), (128, 256, 384), (256, 512, 192), (1024, 512, 192),
                 (768, 256, 384), (384, 128, 768)]
OPT_BATCH = 64
# The attention AEKL (aekl_eeg.yaml with attention_levels [F, F, T] and both
# non-local attentions): each attention's norm is K1 without SiLU at G 1 on
# (64, 768), 49,152 elements a group, the cluster form; K3 in training.
AEKL_ATTN_SHAPE = (64, 768)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,l", OPT_K1_SHAPES)
def test_group_norm_kernels_at_the_scale_shift_chain(c, l, dtype):
    x, scale, bias = _inputs(30, OPT_BATCH, c, l)
    x = x.to(dtype)
    got = group_norm.group_norm_silu(x, scale, bias, 32, 1e-6, False)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x.float(), scale, bias, 32, 1e-6, False)
    _hold(got, want, dtype, 1e-5, 2e-6)
    dx, dx_want = _backward_case(31, 4, c, l, 32, False, dtype)
    _hold(dx, dx_want, dtype, 1e-4, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,l", OPT_K2_SHAPES)
def test_gn_silu_conv3_kernel_at_the_options_unet(cin, cout, l, dtype):
    x, scale, bias, w, bb = _inputs(32, OPT_BATCH, cin, l, cout)
    x, w, bb = x.to(dtype), w.to(dtype), bb.to(dtype)
    got = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
    torch.cuda.synchronize()
    want = fused_resblock.gn_silu_conv3_reference(x.float(), scale, bias, w.float(),
                                                  bb.float(), 32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        err = (got.float() - want).abs()
        tol = BF16_RTOL * want.abs() + 4 * BF16_RTOL * want.square().mean().sqrt()
        assert bool((err <= tol).all()), err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_group_norm_kernels_at_the_aekl_attention_norm(dtype):
    c, l = AEKL_ATTN_SHAPE
    assert _forms(16, c, l, 1, dtype) == {"K1": "cluster", "K3": "cluster"}
    x, scale, bias = _inputs(33, 16, c, l)
    x = x.to(dtype)
    got = group_norm.group_norm_silu(x, scale, bias, 1, 1e-6, False)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x.float(), scale, bias, 1, 1e-6, False)
    _hold(got, want, dtype, 1e-5, 2e-6)
    dx, dx_want = _backward_case(34, 16, c, l, 1, False, dtype)
    _hold(dx, dx_want, dtype, 1e-4, 1e-5)


# The cluster form (csrc/gn_cluster.cuh): aligned groups of ON_CHIP_MAX + 8 to
# CLUSTER_MAX elements, cs = ceil(n / ON_CHIP_MAX) blocks a group. One row
# of ON_CHIP_MAX + 8 straddles the two slices; each cs from 2 to 8 with
# whole slices (4 cs rows of 3072) and with a short last slice (8 rows of
# 1536 cs - 8, rows straddling); rows of 5000 (a row cut by the slice
# boundary between whole ones), one row over four slices, rows of 8 (many
# rows a slice); every (C, L) of the stage-1 step (aekl_eeg.yaml at G 1)
# and the attention AEKL's norm, at batch 2
STAGE1_GN_SHAPES = sorted({(c, l) for c, l, _ in RECON_GN_SHAPES} | {AEKL_ATTN_SHAPE})
CLUSTER_CASES = ([(2, 1, group_norm.ON_CHIP_MAX + 8, 1)]
                 + [(2, 4 * cs, 3072, 1) for cs in range(2, 9)]
                 + [(2, 8, 1536 * cs - 8, 1) for cs in range(2, 9)]
                 + [(2, 3, 5000, 1), (2, 1, 40000, 1), (2, 2048, 8, 1), (3, 256, 3072, 32)]
                 + [(2, c, l, 1) for c, l in STAGE1_GN_SHAPES])
# What stays on the streaming path and the three-pass form: a group of
# CLUSTER_MAX + 8, a ragged row (L % 4 != 0), and L 3076 (a multiple of
# fp32's 4-element vector, not of bf16's 8: the cluster form in fp32 only)
STREAMING_CASES = [(2, 1, group_norm.CLUSTER_MAX + 8, 1), (2, 1, 12290, 1), (2, 4, 3076, 1)]


def _expected_forms(c, l, g, dtype):
    n, vec = c // g * l, 16 // dtype.itemsize
    if group_norm.ON_CHIP_MAX < n <= group_norm.CLUSTER_MAX and l % vec == 0:
        return {"K1": "cluster", "K3": "cluster"}
    return {"K1": "streaming", "K3": "three_pass"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,c,l,g", CLUSTER_CASES + STREAMING_CASES)
def test_group_norm_kernels_in_the_cluster_form(b, c, l, g, dtype):
    """K1 and K3 against their plain versions on each side of ON_CHIP_MAX
    and CLUSTER_MAX, each cs, the stage-1 shapes and the straddling rows,
    in the form the launchers report (``k1.form.<form>``, ``k3.form.<form>``)."""
    assert _forms(b, c, l, g, dtype) == _expected_forms(c, l, g, dtype)
    x, scale, bias = _inputs(41, b, c, l)
    x = x.to(dtype)
    for silu in (True, False):
        got = group_norm.group_norm_silu(x, scale, bias, g, 1e-6, silu)
        torch.cuda.synchronize()
        want = group_norm.group_norm_silu_reference(x.float(), scale, bias, g, 1e-6, silu)
        _hold(got, want, dtype, 1e-5, 2e-6)
        dx, dx_want = _backward_case(42, b, c, l, g, silu, dtype)
        _hold(dx, dx_want, dtype, 1e-4, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,c,l,g", [(2, 1, group_norm.ON_CHIP_MAX + 8, 1), (4, 32, 3072, 1),
                                     (2, 3, 5000, 1), (4, 256, 3072, 32)])
def test_group_norm_cluster_form_is_deterministic(b, c, l, g, dtype):
    """Two launches of each cluster kernel give equal bits: y and stats, dx,
    dscale and dbias (rank-ordered sums, no atomics)."""
    assert _forms(b, c, l, g, dtype) == {"K1": "cluster", "K3": "cluster"}
    x, scale, bias = _inputs(43, b, c, l)
    x = x.to(dtype)
    dy = torch.randn_like(x)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    (y1, s1), (y2, s2) = (group_norm.group_norm_silu_forward(x, scale, bias, g) for _ in "12")
    assert torch.equal(y1.view(ints), y2.view(ints))
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))
    a, b2 = (group_norm.group_norm_silu_backward(x, dy, scale, bias, s1, g) for _ in "12")
    assert torch.equal(a[0].view(ints), b2[0].view(ints))
    for u, v in zip(a[1:], b2[1:]):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_group_norm_cluster_sized_group_on_an_unaligned_base_streams(dtype):
    """A group of cluster size (24,576 elements) whose x is not 16-byte
    aligned takes the streaming path and the three-pass form, same results."""
    b, c, l, g = 2, 4, 6144, 1
    x, scale, bias = _inputs(44, b, c, l)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    buf[1:].copy_(x.flatten())
    xs = buf[1:].view(b, c, l)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    dy = torch.randn(b, c, l, device="cuda").to(dtype)
    profiling.reset()
    y, stats = group_norm.group_norm_silu_forward(xs, scale, bias, g)
    got = group_norm.group_norm_silu_backward(xs, dy, scale, bias, stats, g)
    torch.cuda.synchronize()
    assert _form_counts() == {("K1", "streaming"): 1, ("K3", "three_pass"): 1}
    xf = xs.float()
    _hold(y, group_norm.group_norm_silu_reference(xf, scale, bias, g), dtype, 1e-5, 2e-6)
    want = group_norm.group_norm_silu_backward_reference(xf, dy.float(), scale, bias, stats, g)
    _hold(got[0], want[0], dtype, 1e-4, 1e-5)
    for gv, wv in zip(got[1:], want[1:]):
        torch.testing.assert_close(gv, wv, rtol=1e-4, atol=1e-5 * (b * l) ** 0.5)


def test_int8_products_on_the_card_equal_the_cpu():
    """``torch._int_mm`` on the card at QuantConv1d's padded shapes (k C_in
    = 3, C_out = 1, an M of 16) gives the CPU's int32 accumulators."""
    from sleepgen_torch.nn import quant

    gen = torch.Generator().manual_seed(29)
    for b, cin, cout, l, k in ((64, 1, 128, 768, 3), (64, 128, 1, 768, 3), (1, 8, 24, 16, 1),
                               (4, 256, 768, 192, 1)):
        xq = torch.randint(-127, 128, (b, cin, l), generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, cin, k), generator=gen, dtype=torch.int8)
        want = quant.int8_conv_accumulate(xq, quant.weight_matrix(wq), k, cout)
        got = quant.int8_conv_accumulate(xq.cuda(), quant.weight_matrix(wq.cuda()), k, cout)
        assert torch.equal(got.cpu(), want)


def _kernel_calls(x, scale, bias, w, bb):
    """K1 forward and backward (one GroupNorm + SiLU with a gradient) and two K2 launches."""
    fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 32)
    fused_resblock.gn_silu_conv3(x.bfloat16(), scale, bias, w, bb.bfloat16(), 32)
    xg = x.clone().requires_grad_()
    group_norm.group_norm_silu(xg, scale, bias, 32).sum().backward()
    torch.cuda.synchronize()


def test_kernel_host_counters_count_only_while_tracing():
    """Under ``tracing()`` each wrapper adds its host nanoseconds and the
    launches they cover; the launch counters read as without tracing, and
    nothing is added with the tracer off."""
    inputs = _inputs(51, 4, 64, 768, 64)
    _kernel_calls(*inputs)  # the library built and the weight's tiles laid out
    counts = []
    for traced in (False, True):
        profiling.reset()
        if traced:
            with profiling.tracing():
                _kernel_calls(*inputs)
        else:
            _kernel_calls(*inputs)
        counts.append(profiling.counters())
    off, on = counts
    for key in ("k1.launches", "k2.launches", "k3.launches", "k2.relayouts", "k1.form.on_chip",
                "k3.form.on_chip"):
        assert off[key] == on[key], key
    assert (on["k1.launches"], on["k2.launches"], on["k3.launches"]) == (1, 2, 1)
    for k in ("k1", "k2", "k3"):
        assert off[f"{k}.host_ns"] == off[f"{k}.traced_launches"] == 0
        assert on[f"{k}.host_ns"] > 0 and on[f"{k}.traced_launches"] == on[f"{k}.launches"]
    assert on["k2.traced_relayouts"] == 0


def test_traced_stage2_step_phases_sum_to_the_step():
    """A stage-2 step at the LDM's widths and batch 256 in bf16 (card-bound):
    the device ms of its four phases, between the tracer's CUDA events, are
    each >= 0 and sum to within 5 % of the step's synchronised time."""
    import time

    from sleepgen_torch.diffusion.schedules import NoiseSchedule
    from sleepgen_torch.nn.aekl import AutoencoderKL
    from sleepgen_torch.nn.layers import cast_compute_dtype
    from sleepgen_torch.nn.unet1d import UNet1d
    from sleepgen_torch.train.train_ldm import make_ldm_train_step

    torch.manual_seed(0)
    with torch.device("cuda"):
        ae = cast_compute_dtype(AutoencoderKL().eval(), torch.bfloat16).requires_grad_(False)
        unet = UNet1d(attention_resolutions=(4,))
    sched = NoiseSchedule.create("linear_beta", 1000, 0.0015, 0.0195, device="cuda")
    step = make_ldm_train_step(unet, ae, sched, torch.optim.Adam(unet.parameters(), lr=1e-4),
                               1.0, torch.bfloat16)
    b = 256
    x = torch.randn((b, 1, 3072), device="cuda")
    t = torch.randint(0, 1000, (b,), device="cuda")
    noise, eps = torch.randn((b, 1, 768), device="cuda"), torch.randn((b, 1, 768), device="cuda")
    for _ in range(3):
        step(x, t, noise, eps)
    profiling.reset()
    torch.cuda.synchronize()
    with profiling.tracing():
        t0 = time.perf_counter()
        step(x, t, noise, eps)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    spans = profiling.spans()
    (root,) = [s for s in spans if s["name"] == "trainer.step"]
    phases = {s["name"]: s["device_ms"] for s in spans if s["parent"] == root["id"]}
    assert list(phases) == ["trainer.encode", "trainer.forward", "trainer.backward",
                            "trainer.optimizer"]
    assert all(ms is not None and ms >= 0 for ms in phases.values()), phases
    assert abs(sum(phases.values()) - step_ms) <= 0.05 * step_ms, (phases, step_ms)


# -- the DDIM loop's CUDA graph (sample/samplers.py) ----------------------------

def _ldm_parts(steps=5, batch=4, dtype=torch.bfloat16, length=768, **unet_kw):
    """A UNet at the LDM's widths with torch's initial weights (no parameter
    needing a gradient), the sampling schedule, and x_T."""
    from sleepgen_torch.diffusion.schedules import NoiseSchedule
    from sleepgen_torch.nn.layers import cast_compute_dtype
    from sleepgen_torch.nn.unet1d import UNet1d

    torch.manual_seed(61)
    with torch.device("cuda"):
        unet = UNet1d(attention_resolutions=unet_kw.pop("attention_resolutions", (4,)),
                      **unet_kw)
    unet = cast_compute_dtype(unet.eval(), dtype).requires_grad_(False)
    sched = NoiseSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                                 prediction_type="v_prediction", device="cuda")
    x_T = torch.randn((batch, 1, length), generator=torch.Generator().manual_seed(62)).cuda()
    return unet, sched, x_T


def _graphed(model_fn, sched, x_T, steps):
    """The loop as the samplers run it: no autograd, so its steps replay a graph."""
    from sleepgen_torch.sample.samplers import ddim_sample_loop

    with torch.inference_mode():
        return ddim_sample_loop(model_fn, sched, x_T, steps)


def _eager(model_fn, sched, x_T, steps):
    """The same loop step by step: grad mode on, no parameter needing a gradient."""
    from sleepgen_torch.sample.samplers import ddim_sample_loop

    with torch.enable_grad():
        return ddim_sample_loop(model_fn, sched, x_T, steps)


def _graph_counts():
    c = profiling.counters()
    return c["sampler.graph_captures"], c["sampler.graph_replays"]


@pytest.mark.parametrize("model", ["ldm", "dm", "ldm-int8"])
def test_ddim_graph_gives_the_eager_bits(model):
    """The loop replaying its graph gives the eager loop's bits: on the call
    that captures (step 0 eager, then replays) and on one that only replays."""
    from sleepgen_torch.nn.layers import cast_compute_dtype
    from sleepgen_torch.nn.unet1d import quantize_unet

    steps = 5
    if model == "dm":
        unet, sched, x_T = _ldm_parts(batch=2, length=3072, attention_resolutions=(8, 4))
    elif model == "ldm-int8":  # quantized from fp32 weights, run in bf16, as the samplers do
        unet, sched, x_T = _ldm_parts(dtype=torch.float32)
        unet = cast_compute_dtype(quantize_unet(unet), torch.bfloat16).requires_grad_(False)
    else:
        unet, sched, x_T = _ldm_parts()
    want = _eager(unet, sched, x_T, steps)
    before = _graph_counts()
    first = _graphed(unet, sched, x_T, steps)
    second = _graphed(unet, sched, x_T, steps)
    after = _graph_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 2 * steps - 1)
    assert torch.isfinite(want).all()
    assert torch.equal(first, want) and torch.equal(second, want)


def test_ldm_sampler_replays_and_gives_the_eager_bits():
    """``make_ldm_sampler``'s DDIM call (batch 4, AEKL decode) replays its
    steps from the second call on and gives the eager loop's windows."""
    from sleepgen_torch.nn.aekl import AutoencoderKL
    from sleepgen_torch.nn.layers import cast_compute_dtype
    from sleepgen_torch.sample.sample_ldm import make_ldm_sampler
    from sleepgen_torch.sample.samplers import seed_noise

    unet, sched, _ = _ldm_parts()
    with torch.device("cuda"):
        ae = cast_compute_dtype(AutoencoderKL().eval(), torch.bfloat16).requires_grad_(False)
    sample = make_ldm_sampler(unet, ae, sched, num_inference_steps=4, device="cuda")
    seeds = [3, 4, 5, 6]
    z = _eager(unet, sched, seed_noise(seeds, (768, 1), "cuda").transpose(1, 2), 4)
    with torch.inference_mode():
        signal = ae.decode_stage_2_outputs(z / 1.5).float()
    want = signal[:, :, 36:-36].transpose(1, 2)
    before = _graph_counts()
    got = [sample(1.5, seeds) for _ in range(3)]
    after = _graph_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 3 * 4 - 1)
    assert all(torch.equal(g, want) for g in got)


def test_guided_closure_captures_per_call_and_frees_its_graph():
    """A closure made per call (guided sampling) captures on each call, and
    its graph goes with it."""
    from sleepgen_torch.sample import samplers

    unet, sched, x_T = _ldm_parts(batch=2, num_classes=5)
    labels = torch.tensor([1, 3], device="cuda")
    want = _eager(samplers.cond_model_fn(unet, labels, 2.0), sched, x_T, 3)
    before = _graph_counts()
    for _ in range(2):
        got = _graphed(samplers.cond_model_fn(unet, labels, 2.0), sched, x_T, 3)
        assert torch.equal(got, want)
    after = _graph_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (2, 4)
    assert not any(k is not unet for k in samplers._graphs.keys())


@pytest.mark.parametrize("change", ["k2_weight_in_place", "k2_relayout", "other_weight"])
def test_ddim_graph_follows_weight_updates(change):
    """After an in-place update of a K2 weight, or its re-layout by an eager
    call, the loop captures again and samples the new weights; a weight that
    cuDNN reads in place needs no new capture."""
    unet, sched, x_T = _ldm_parts()
    _graphed(unet, sched, x_T, 3)
    conv = unet.input_blocks[1][0].in_layers["2"]  # the first resblock's K2 convolution
    with torch.no_grad():
        if change == "other_weight":
            unet.input_blocks[0][0].weight.mul_(1.5)  # conv_in, a cuDNN convolution
        else:
            conv.weight.mul_(1.5)
    if change == "k2_relayout":
        _eager(unet, sched, x_T, 1)  # K2's cache lays the updated weight out again
    before = _graph_counts()
    got = _graphed(unet, sched, x_T, 3)
    captures = _graph_counts()[0] - before[0]
    assert captures == (0 if change == "other_weight" else 1)
    assert torch.equal(got, _eager(unet, sched, x_T, 3))


def test_ddim_graph_outputs_do_not_alias():
    """Each call returns a tensor of its own: a later call does not touch it."""
    unet, sched, x_T = _ldm_parts(batch=2)
    a = _graphed(unet, sched, x_T, 3)
    kept = a.clone()
    b = _graphed(unet, sched, x_T * 0.5, 3)
    c = _graphed(unet, sched, x_T, 3)
    assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    assert torch.equal(a, kept) and torch.equal(c, kept) and not torch.equal(b, kept)


def test_ddim_graph_replays_count_the_eager_launches():
    """K1's, K2's and K3's launch counters, by shape and by form, read after
    a capturing call and after a replaying one as after the eager loop."""
    unet, sched, x_T = _ldm_parts(batch=2)
    _eager(unet, sched, x_T, 1)

    def counted(run):
        profiling.reset()
        run(unet, sched, x_T, 4)
        torch.cuda.synchronize()
        return (_count("k1.launches"), _count("k3.launches"), _count("k2.launches"),
                profiling.keyed("k1.launch_shapes"), _form_counts(),
                profiling.keyed("k2.launch_shapes"))

    want = counted(_eager)
    assert want[0] > 0 and want[2] > 0
    assert counted(_graphed) == want  # capturing: step 0 eager, 3 replays
    assert counted(_graphed) == want  # 4 replays


def test_ddim_graph_captures_and_replays_under_the_tracer():
    """With the tracer on, the capture works (its spans hold no CUDA events),
    every step is a ``sampler.step`` span with device time, the replays made
    while tracing are counted, and the bits are the eager loop's."""
    unet, sched, x_T = _ldm_parts(batch=2)
    want = _eager(unet, sched, x_T, 4)
    profiling.reset()
    with profiling.tracing():
        got = [_graphed(unet, sched, x_T, 4) for _ in range(2)]
    spans = profiling.spans()
    steps = [s for s in spans if s["name"] == "sampler.step"]
    assert len(steps) == 8 and all(s["device_ms"] is not None for s in steps)
    assert len([s for s in spans if s["name"] == "sampler.capture"]) == 1
    c = profiling.counters()
    assert (c["sampler.graph_captures"], c["sampler.graph_replays"],
            c["sampler.traced_graph_replays"]) == (1, 7, 7)
    assert all(torch.equal(g, want) for g in got)
    profiling.reset()


# -- the DiT denoiser (nn/dit.py) ----------------------------------------------

DIT_XL2 = dict(in_channels=1, input_size=768, patch_size=2, hidden_size=1152, depth=28,
               num_heads=16, mlp_ratio=4.0, num_classes=5)


def _dit_state(seed=19, **kw):
    """Seeded weights of the benchmark's reference DiT (bf16 values in fp32,
    every gate and final weight non-zero) on the card."""
    from portbench import weights
    from portbench.reference import dit as rdit

    with torch.device("meta"):
        shapes = weights.shapes_of(rdit.DiT(**{**DIT_XL2, **kw}))
    return weights.make_state(shapes, set(), seed, "cuda", weights.WEIGHTS_UNET)


def _bf16_dit(state, **kw):
    from sleepgen_torch.nn.dit import DiT1d
    from sleepgen_torch.nn.layers import cast_compute_dtype

    with torch.device("cuda"):
        model = DiT1d(**{**DIT_XL2, **kw})
    model.load_state_dict(state)
    return cast_compute_dtype(model.eval(), torch.bfloat16).requires_grad_(False)


def test_dit_xl2_bf16_forward_against_the_fp32_reference():
    """DiT-XL/2 at every published width in bf16 against the fp32 reference
    on the same weights: closer to it than the reference computed with fp8
    products is, by half at least (bf16 keeps 8 bits of mantissa, e4m3 4)."""
    from portbench.reference import dit as rdit, models as ref

    state = _dit_state()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 1, 768), generator=g, device="cuda")
    t = torch.tensor([0, 50, 200, 400, 600, 800, 950, 999], device="cuda")
    y = torch.tensor([0, 1, 2, 3, 4, -1, 2, -1], device="cuda")
    ref_y = torch.where(y < 0, 5, y)
    model = _bf16_dit(state)
    with torch.no_grad():
        before = _count("k4.launches")
        got = model(x, t, y)
        launched = _count("k4.launches") - before
        want, fp8 = (rdit.DiT(**DIT_XL2, prec=ref.Precision(p)).cuda().eval() for p in
                     ("fp32", "fp8"))
        want.load_state_dict(state)
        fp8.load_state_dict(state)
        want, fp8 = want(x, t, ref_y), fp8(x, t, ref_y)
    err = float((got - want).norm() / want.norm())
    err_fp8 = float((fp8 - want).norm() / want.norm())
    print(f"DiT-XL/2 bf16 rel err {err:.5f}, fp8 reference {err_fp8:.5f}")
    assert torch.isfinite(got).all() and err <= 0.5 * err_fp8, (err, err_fp8)
    assert launched == 2 * DIT_XL2["depth"] + 1  # every pass between half-blocks ran K4


def test_dit_attention_takes_a_fused_sdpa_kernel():
    """The DiT's attention at 16 heads of 72 in bf16 runs a fused SDPA
    kernel (flash or memory-efficient), by the profiler's kernel names."""
    from torch.profiler import ProfilerActivity, profile

    from sleepgen_torch.nn.dit import Attention

    with torch.device("cuda"):
        attn = Attention(1152, 16).to(torch.bfloat16).eval()
    x = torch.randn((128, 384, 1152), device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        attn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            attn(x)
            torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
    fused = sorted(n for n in names if any(k in n.lower() for k in ("flash", "fmha", "mem_eff",
                                                                   "efficient_attention")))
    print("DiT SDPA kernels:", fused)
    assert fused, sorted(names)


def test_dit_ddim_graph_gives_the_eager_bits():
    """A DiT at the published widths (two blocks) replays the DDIM step's
    graph with the eager loop's bits, plain and guided."""
    from sleepgen_torch.diffusion.schedules import NoiseSchedule
    from sleepgen_torch.sample import samplers

    model = _bf16_dit(_dit_state(depth=2), depth=2)
    sched = NoiseSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                                 prediction_type="v_prediction", device="cuda")
    x_T = torch.randn((4, 1, 768), generator=torch.Generator().manual_seed(62)).cuda()
    labels = torch.tensor([0, 1, 2, 3], device="cuda")
    guided = samplers.cond_model_fn(model, labels, 1.5)
    for model_fn in (model, guided):
        want = _eager(model_fn, sched, x_T, 5)
        before = _graph_counts()
        got = [_graphed(model_fn, sched, x_T, 5) for _ in range(2)]
        after = _graph_counts()
        assert (after[0] - before[0], after[1] - before[1]) == (1, 9)
        assert torch.isfinite(want).all() and all(torch.equal(g, want) for g in got)


def test_dit_sampler_launches_only_the_decodes_k1():
    """A DDIM call of the DiT sampler (graph path) launches K1 as many times
    as the AEKL decode alone does, and no K2."""
    from sleepgen_torch.diffusion.schedules import NoiseSchedule
    from sleepgen_torch.nn.aekl import AutoencoderKL
    from sleepgen_torch.nn.layers import cast_compute_dtype
    from sleepgen_torch.sample.sample_ldm import make_ldm_sampler

    model = _bf16_dit(_dit_state(depth=2), depth=2)
    with torch.device("cuda"):
        ae = cast_compute_dtype(AutoencoderKL().eval(), torch.bfloat16).requires_grad_(False)
    sched = NoiseSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                                 prediction_type="v_prediction", device="cuda")
    sample = make_ldm_sampler(model, ae, sched, num_inference_steps=4, device="cuda")
    sample(1.0, [1, 2])
    z = torch.randn((2, 1, 768), device="cuda")

    def launched(fn):
        torch.cuda.synchronize()
        profiling.reset()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        return _count("k1.launches"), _count("k2.launches")

    decode = launched(lambda: ae.decode_stage_2_outputs(z))
    assert decode[0] > 0
    assert launched(lambda: sample(1.0, [3, 4])) == (decode[0], 0)


# -- K4: the DiT's pass between half-blocks (kernels/adaln.py) -------------------

# (B, T, D): the DiT cell's guided forward (128 rows of 384 tokens at 1152), odd
# row counts, D 64 and 72 (fewer float4s than a warp has lanes) and 2048 (the
# widest K4 takes)
K4_SHAPES = [(128, 384, 1152), (3, 7, 1152), (5, 13, 64), (2, 9, 72), (3, 5, 2048)]
MANTISSA_BITS = {torch.bfloat16: 7, torch.float32: 23}


def _k4_inputs(b, t, d, dtype, seed=0):
    """x (B, T, D) fp32 off zero; gate, shift and scale chunks of one (B, 6 D)
    projection in ``dtype``; h (B, T, D) in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 3.0 * torch.randn((b, t, d), generator=g, device="cuda") + 0.5
    mods = (0.3 * torch.randn((b, 6 * d), generator=g, device="cuda")).to(dtype).chunk(6, dim=1)
    h = torch.randn((b, t, d), generator=g, device="cuda").to(dtype)
    return x, mods[0], mods[1], mods[2], h


def _assert_within_one_ulp(got, want):
    """Elementwise within one unit in the last place of the output dtype at
    the larger magnitude of the two, beyond an fp32 floor of 1e-6 of the
    largest |want| (the composed ops' Welford statistics and unfused
    residual round otherwise than K4's two-pass statistics and FMA)."""
    got, want, bits = got.float(), want.float(), MANTISSA_BITS[got.dtype]
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 1 - bits)
    excess = (got - want).abs() - ulp - 1e-6 * want.abs().max()
    assert float(excess.max()) <= 0, float(excess.max())


@pytest.mark.parametrize("form", ["first", "residual", "final"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,d", K4_SHAPES)
def test_adaln_modulate_kernel(b, t, d, dtype, form):
    """K4 against the composed ops: no pending branch, the gated residual
    written back in place, and the final layer's (x left as it was; shift
    and scale from a (B, 2 D) projection, the gate from a block's (B, 6 D));
    x_new within 1e-6 of max |x|, y within one ulp; the same bits twice."""
    x, shift, scale, gate, h = _k4_inputs(b, t, d, dtype)
    if form == "final":
        shift, scale = _k4_inputs(b, t, d, dtype, seed=1)[1:3]
        shift, scale = torch.stack([shift, scale], dim=1).reshape(b, 2 * d).chunk(2, dim=1)
        assert (shift.stride(0), gate.stride(0)) == (2 * d, 6 * d)
    pending = None if form == "first" else (h, gate)
    want_x, want_y = adaln.adaln_modulate_reference(x, shift, scale, dtype, pending)
    stream = x.clone()
    before = _count("k4.launches")
    got_x, got_y = adaln.adaln_modulate(stream, shift, scale, dtype, pending,
                                        write_back=form != "final")
    torch.cuda.synchronize()
    assert _count("k4.launches") == before + 1
    assert got_y.dtype == dtype and got_y.shape == x.shape
    if form == "residual":
        assert got_x is stream
        assert float((stream - want_x).abs().max()) <= 1e-6 * float(x.abs().max())
    else:
        assert torch.equal(stream, x) and (got_x is None) == (form == "final")
    _assert_within_one_ulp(got_y, want_y)
    again = adaln.adaln_modulate(x.clone(), shift, scale, dtype, pending)[1]
    assert torch.equal(again, got_y)


def test_adaln_modulate_raises_on_what_k4_does_not_take():
    """D not a multiple of 4 or above 2048, fp16, a bf16 stream, a strided
    stream or h: the wrapper raises and launches nothing, never running the
    composed ops on the card; inputs autograd follows, and autocast, run
    the composed ops."""
    x, shift, scale, gate, h = _k4_inputs(2, 3, 64, torch.bfloat16)
    bf16 = torch.bfloat16
    cases = [(torch.zeros((2, 3, 66), device="cuda"), *_k4_inputs(2, 3, 66, bf16)[1:3], bf16,
              None),
             (*_k4_inputs(1, 2, 2052, bf16)[:3], bf16, None),
             (x, shift.half(), scale.half(), torch.float16, None),
             (x.to(bf16), shift, scale, bf16, None),
             (x.transpose(0, 1).contiguous().transpose(0, 1), shift, scale, bf16, None),
             (x, shift, scale, bf16, (h.transpose(0, 1).contiguous().transpose(0, 1), gate))]
    before = _count("k4.launches")
    for case in cases:
        with pytest.raises(ValueError, match="adaln_modulate"):
            adaln.adaln_modulate(*case)
    assert _count("k4.launches") == before
    x_new, y = adaln.adaln_modulate(x.clone().requires_grad_(), shift, scale, bf16, (h, gate))
    assert x_new.grad_fn is not None and _count("k4.launches") == before
    with torch.autocast("cuda", dtype=bf16):
        adaln.adaln_modulate(x, shift, scale, torch.float32, (h, gate))
    assert _count("k4.launches") == before
    adaln.adaln_modulate(x, shift, scale, bf16, (h, gate))
    assert _count("k4.launches") == before + 1


def test_dit_raises_on_a_strided_stream_or_fp16():
    """An fp16 DiT raises at its first pass under inference mode, and the
    pass raises on a strided stream, instead of running the composed ops;
    the bf16 DiT then runs K4 at each of its 2 depth + 1 passes."""
    from sleepgen_torch.nn import dit as ndit
    from sleepgen_torch.nn.layers import cast_compute_dtype

    model = _bf16_dit(_dit_state(depth=1), depth=1)
    fp16 = cast_compute_dtype(copy.deepcopy(model), torch.float16)
    x = torch.randn((2, 1, 768), generator=torch.Generator().manual_seed(4)).cuda()
    t, y = torch.tensor([5, 600], device="cuda"), torch.tensor([0, -1], device="cuda")
    stream, shift, scale, gate, h = _k4_inputs(2, 384, 1152, torch.bfloat16)
    strided = stream.transpose(1, 2).contiguous().transpose(1, 2)
    before = _count("k4.launches")
    with torch.inference_mode():
        with pytest.raises(ValueError, match="compute dtype"):
            fp16(x, t, y)
        with pytest.raises(ValueError, match="contiguous"):
            ndit.modulate(strided, shift, scale, torch.bfloat16, (h, gate))
        assert _count("k4.launches") == before
        model(x, t, y)
    assert _count("k4.launches") == before + 2 * 1 + 1


def test_dit_runs_k4_at_every_pass_only_without_autograd():
    """Under inference mode each forward counts 2 depth + 1 passes in
    ``dit.fused_norms``; with parameters that need gradients (training) the
    composed ops run, none counts, and the output is the K4 forward's within
    fp32 rounding."""
    from sleepgen_torch.nn import dit as ndit

    depth = 2
    state = _dit_state(depth=depth)
    model = _bf16_dit(state, depth=depth)
    x = torch.randn((4, 1, 768), generator=torch.Generator().manual_seed(3)).cuda()
    t = torch.tensor([5, 300, 600, 990], device="cuda")
    y = torch.tensor([0, 2, 4, -1], device="cuda")
    profiling.reset()
    with profiling.tracing(), torch.inference_mode():
        model(x, t, y)
        model(x, t, y)
    c = profiling.counters()
    assert (c["dit.forwards"], c["dit.fused_norms"]) == (2, 2 * (2 * depth + 1))
    with torch.device("cuda"):
        fp32 = ndit.DiT1d(**{**DIT_XL2, "depth": depth})
    fp32.load_state_dict(state)
    profiling.reset()
    with profiling.tracing():
        trained = fp32(x, t, y)
        trained.square().mean().backward()
    assert profiling.counters()["dit.fused_norms"] == 0
    with torch.no_grad():
        before = _count("k4.launches")
        fused = fp32(x, t, y)
        assert _count("k4.launches") - before == 2 * depth + 1
    profiling.reset()
    trained = trained.detach()
    err = float((fused - trained).norm() / trained.norm())
    print(f"DiT fp32 forward, K4 against the composed ops: rel err {err:.3e}")
    assert err < 1e-5, err


def test_adaln_modulate_time_at_the_dit_cell():
    """K4's device ms a pass at the cell's shape (bf16, gated residual written
    back) against its byte bound, and the composed ops' ms for the same pass."""
    b, t, d = 128, 384, 1152
    x, shift, scale, gate, h = _k4_inputs(b, t, d, torch.bfloat16)
    pending, n = (h, gate), 50

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    with torch.inference_mode():
        k4 = per_call(lambda: adaln.adaln_modulate(x, shift, scale, torch.bfloat16, pending))
        composed = per_call(lambda: adaln.adaln_modulate_reference(x, shift, scale,
                                                                   torch.bfloat16, pending))
    moved = b * t * d * (4 + 2 + 4 + 2)  # read x and h, write x_new and y
    bound = moved / 3.35e12 * 1e3
    print(f"K4 adaln_modulate ({b}, {t}, {d}) bf16: {k4:.4f} ms a pass, bound {bound:.4f} ms "
          f"({moved / 1e6:.1f} MB at 3.35 TB/s, {100 * bound / k4:.1f} %); "
          f"composed ops {composed:.4f} ms; {torch.cuda.get_device_name(0)}")
    assert k4 > 0


# -- K5: the UNet's attention (kernels/attention.py, csrc/attention.cu) ----------

def _qkv(seed, b, heads, d, l, sigma=1.0):
    """(B, 3 heads d, L) bf16 with N(0, sigma^2) entries."""
    rng = np.random.default_rng(seed)
    x = (sigma * rng.standard_normal((b, 3 * heads * d, l))).astype(np.float32)
    return torch.from_numpy(x).cuda().bfloat16()


def _k5_folded(qkv, heads):
    """K5's arithmetic in fp32 on the card: the logits of q and k as they
    are times d^-1/2, an fp32 softmax, the weights p rounded to bf16, their
    product with v in fp32, rounded to bf16. Also p |v|, the size of what
    each output sums."""
    b, c3, l = qkv.shape
    d = c3 // (3 * heads)
    q, k, v = qkv.reshape(b, heads, 3 * d, l).split(d, dim=2)
    logits = torch.einsum("bhci,bhcj->bhij", q.float(), k.float()) / d ** 0.5
    weights = torch.softmax(logits, dim=-1).bfloat16().float()
    out = torch.einsum("bhij,bhcj->bhci", weights, v.float())
    size = torch.einsum("bhij,bhcj->bhci", weights, v.float().abs())
    return out.bfloat16().reshape(b, c3 // 3, l), size.reshape(b, c3 // 3, l)


def _hold_k5_arithmetic(got, qkv, heads):
    """K5 against its own arithmetic (``_k5_folded``): the two take sums in
    other orders and K5's exp2 is approximate, so a weight may round to
    bf16 the other way (a step of 2^-8 of itself) and an output by as much
    as 2^-8 of the sum of its terms' sizes, sum_j p_j |v_j|, plus a step
    of its own rounding (2^-7 of itself); and over the whole output the
    relative L2 gap stays under 2^-10 (1.1e-4 to 1.8e-4 measured on an
    H100, where two fp32 formulations of the same softmax in torch differ
    by 0.5e-4 to 0.9e-4)."""
    folded, size = _k5_folded(qkv, heads)
    got, folded = got.float(), folded.float()
    err = (got - folded).abs()
    tol = 2.0**-8 * size + 2.0**-7 * torch.maximum(got.abs(), folded.abs())
    assert bool((err <= tol).all()), f"K5 vs its arithmetic: max err {float(err.max())}"
    rel = float((got - folded).norm() / folded.norm())
    assert rel < 2.0**-10, f"K5 vs its arithmetic: relative L2 gap {rel}"


def _hold_k5(got, qkv, heads):
    """K5 against its own arithmetic (``_hold_k5_arithmetic``), and against
    the plain version within 2^-5 (|ref| + rms(ref)): the plain version
    rounds q d^-1/4 and k d^-1/4 to bf16 before their product, as the JAX
    package does, which moves each logit by about 2^-9 of its terms' root
    sum of squares and each weight by as much relatively; at these
    unit-variance inputs the two differ by up to 0.02 (|ref| + rms) in an
    fp32 emulation on the CPU, and by 4.0e-3 in relative L2 on an H100."""
    _hold_k5_arithmetic(got, qkv, heads)
    got = got.float()
    plain = attention.attention_reference(qkv, heads).float()
    err = (got - plain).abs()
    tol = 2.0**-5 * (plain.abs() + plain.square().mean().sqrt())
    assert bool((err <= tol).all()), f"K5 vs its plain version: max err {float(err.max())}"
    return float(err.max())


# (B, heads, d, L): the LDM's and the DM's attention (batch 64, one head of
# 512 at L 192 and 768), several heads, ragged lengths (L not a multiple of
# 64, a key block of one warpgroup past L) and the shortest row
K5_SHAPES = [(64, 1, 512, 192), (64, 1, 512, 768), (8, 4, 64, 320), (4, 2, 128, 704),
             (3, 1, 256, 136), (2, 2, 64, 8)]


@pytest.mark.parametrize("b,heads,d,l", K5_SHAPES)
def test_attention_kernel_against_its_plain_version(b, heads, d, l):
    qkv = _qkv(41, b, heads, d, l)
    with torch.no_grad():
        got = attention.fused_attention(qkv, heads)
    torch.cuda.synchronize()
    assert got.shape == (b, heads * d, l) and got.dtype == torch.bfloat16
    _hold_k5(got, qkv, heads)


def test_attention_kernel_with_peaked_rows():
    """Logits of rms 4 (inputs of rms 2 at d 64): rows with few large
    weights, held to the kernel's own arithmetic."""
    qkv = _qkv(42, 8, 4, 64, 320, sigma=2.0)
    with torch.no_grad():
        got = attention.fused_attention(qkv, 4)
    _hold_k5_arithmetic(got, qkv, 4)


def test_attention_kernel_is_deterministic_and_replays_in_a_graph():
    """Two eager launches give the same bits, and a CUDA graph captured over
    K5 replays them on the captured buffer's new contents; the capture's
    launch count, taken back and added per replay as the DDIM graph does,
    reaches ``k5.launches`` and, while the tracer records, ``k5.traced_launches``."""
    qkv = _qkv(43, 16, 1, 512, 768)
    with torch.no_grad():
        eager = attention.fused_attention(qkv, 1)
        assert torch.equal(attention.fused_attention(qkv, 1).view(torch.int16),
                           eager.view(torch.int16))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            attention.fused_attention(qkv, 1)
        torch.cuda.current_stream().wait_stream(side)
        profiling.reset()
        before = profiling.snapshot_counts()
        graph = torch.cuda.CUDAGraph()
        with profiling.tracing(), torch.cuda.graph(graph):
            out = attention.fused_attention(qkv, 1)
        made = profiling.take_back_counts(before)
        assert made["k5.launches"] == 1 and _count("k5.traced_launches") == 0
        qkv.copy_(qkv.flip(0))
        graph.replay()
        flipped = out.clone()
        qkv.copy_(qkv.flip(0))
        with profiling.tracing():
            graph.replay()
            profiling.add_counts(made, 1)
        profiling.add_counts(made, 1)
        torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), eager.view(torch.int16))
    assert torch.equal(flipped.view(torch.int16), eager.flip(0).view(torch.int16))
    assert (_count("k5.launches"), _count("k5.traced_launches")) == (2, 1)


def test_attention_kernel_raises_on_what_it_does_not_take():
    """K5's launcher raises, and launches nothing, under autograd, on fp32,
    fp16, a strided qkv, a head dim that is not a multiple of 64 up to 512,
    and a row past 768 positions or not a multiple of 8."""
    qkv = _qkv(44, 2, 1, 512, 192)
    grad = qkv.float().requires_grad_(True)
    profiling.reset()
    with pytest.raises(ValueError, match="no backward"):
        attention.fused_attention(grad.bfloat16(), 1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="bf16"):
            attention.fused_attention(qkv.float(), 1)
        with pytest.raises(ValueError, match="bf16"):
            attention.fused_attention(qkv.half(), 1)
        with pytest.raises(ValueError, match="contiguous"):
            attention.fused_attention(_qkv(44, 2, 1, 512, 384)[:, :, ::2], 1)
        for heads, d, l in ((1, 96, 192), (1, 576, 192), (2, 32, 64), (1, 64, 776), (1, 64, 100)):
            with pytest.raises(ValueError, match="out of range"):
                attention.fused_attention(_qkv(45, 2, heads, d, l), heads)
    assert _count("k5.launches") == 0


def test_attention_routes_to_k5_only_on_its_path():
    """On the card: a bf16 fast-math attention without gradient runs K5; under
    autograd, on the strict path and in fp32 it runs SDPA (K5 uncounted);
    past K5's longest row it runs SDPA and counts ``k5.declined``."""
    from sleepgen_torch.nn.layers import attention as layer_attention

    qkv = _qkv(46, 2, 1, 512, 192)
    profiling.reset()
    with torch.no_grad():
        fused = layer_attention(qkv, 1)
        assert _count("k5.launches") == 1
        layer_attention(qkv, 1, mixed_precision=False)
        layer_attention(qkv.float(), 1)
        long = _qkv(47, 2, 1, 64, 1024)
        layer_attention(long, 1)
    trained = layer_attention(qkv.float().requires_grad_(True).bfloat16(), 1)
    trained.float().sum().backward()
    assert (_count("k5.launches"), _count("k5.declined")) == (1, 1)
    _hold_k5(fused, qkv, 1)


def test_ddim_steps_run_k5_at_every_unet_attention():
    """A DDIM loop of the DM's UNet (attention at ds 4: one head of 512 at L
    768) replaying its graph counts one K5 launch per attention block per
    step, and so do its traced replays."""
    steps = 3
    unet, sched, x_T = _ldm_parts(batch=2, length=3072, attention_resolutions=(8, 4))
    blocks = sum(type(m).__name__ == "AttentionBlock1d" for m in unet.modules())
    assert blocks == 6
    _graphed(unet, sched, x_T, steps)  # captures
    profiling.reset()
    with profiling.tracing():
        _graphed(unet, sched, x_T, steps)
    torch.cuda.synchronize()
    c = profiling.counters()
    assert c["k5.launches"] == c["k5.traced_launches"] == blocks * steps
    assert c["k5.declined"] == 0


def test_attention_kernel_time_at_the_sampling_cells():
    """K5's device ms a call at the LDM's and the DM's shapes (batch 64, one
    head of 512, L 192 and 768) against its bound, beside its plain version
    and SDPA on contiguous q, k and v, the library yardstick."""
    import torch.nn.functional as F

    n = 20

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for l in (192, 768):
        b, d = 64, 512
        qkv = _qkv(48, b, 1, d, l)
        q, k, v = (t.transpose(-1, -2).contiguous() for t in _split(qkv, d))
        with torch.no_grad():
            k5 = per_call(lambda: attention.fused_attention(qkv, 1))
            plain = per_call(lambda: attention.attention_reference(qkv, 1))
            sdpa = per_call(lambda: F.scaled_dot_product_attention(q, k, v))
        t_ops = 4 * b * l * l * d / 989e12
        t_bytes = 4 * b * l * d * 2 / 3.35e12
        bound = 1e3 * max(t_ops, t_bytes)
        print(f"K5 attention ({b}, 1, {d}, {l}): {k5:.4f} ms a call; bound {bound:.4f} ms "
              f"({'operations' if t_ops > t_bytes else 'bytes'}, {100 * bound / k5:.1f} %); "
              f"plain {plain:.4f} ms; SDPA contiguous {sdpa:.4f} ms; "
              f"{torch.cuda.get_device_name(0)}")
        assert k5 > 0


def _split(qkv, d):
    """q, k, v of a one-head qkv as (B, 1, d, L) views."""
    b, _, l = qkv.shape
    return qkv.reshape(b, 1, 3 * d, l).split(d, dim=2)
