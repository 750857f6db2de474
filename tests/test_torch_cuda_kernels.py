"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit; the ``cuda_card``
fixture skips them elsewhere. On the H100 they run with
``python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py``
(``--noconftest``: the suite's conftest imports JAX, which that machine
lacks). Tolerances: fp32 at the bounds of tests/test_pallas_kernels.py
(K1 rtol 1e-5 / atol 2e-6, K2 2e-4), with TF32 off for the plain version;
bf16 against the plain version in fp32 on the same bf16 inputs, to bf16
output rounding (K2 also rounds h to bf16 before its convolution).
"""
import numpy as np
import pytest
import torch

from sleepgen_torch.kernels import fused_resblock, group_norm

pytestmark = pytest.mark.usefixtures("cuda_card")

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


@pytest.mark.parametrize("b,c,l,g", [(2, 16, 64, 4), (3, 64, 768, 1),
                                     (4, 128, 768, 32), (2, 24, 37, 8),
                                     (2, 32, 3072, 1)])
@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_silu_kernel_fp32(b, c, l, g, apply_silu):
    x, scale, bias = _inputs(0, b, c, l)
    got = group_norm.group_norm_silu(x, scale, bias, g, 1e-6, apply_silu)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(x, scale, bias, g, 1e-6, apply_silu)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("b,c,l,g", [(4, 128, 768, 32), (2, 32, 3072, 1)])
def test_group_norm_silu_kernel_bf16(b, c, l, g):
    x, scale, bias = _inputs(1, b, c, l)
    xb = x.bfloat16()
    got = group_norm.group_norm_silu(xb, scale, bias, g)
    torch.cuda.synchronize()
    want = group_norm.group_norm_silu_reference(xb.float(), scale, bias, g)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    assert bool((err <= BF16_RTOL * want.abs() + 1e-5).all()), err.max()


@pytest.mark.parametrize("b,cin,cout,l,g", [(2, 16, 16, 64, 8), (2, 32, 64, 96, 32),
                                            (3, 128, 256, 384, 32), (2, 24, 40, 37, 4),
                                            (2, 1024, 512, 192, 32)])
def test_gn_silu_conv3_kernel_fp32(b, cin, cout, l, g):
    x, scale, bias, w, bb = _inputs(2, b, cin, l, cout)
    got = fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, g)
    torch.cuda.synchronize()
    want = fused_resblock.gn_silu_conv3_reference(x, scale, bias, w, bb, g)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,cin,cout,l,g", [(2, 128, 128, 768, 32), (2, 1024, 512, 192, 32),
                                            (2, 24, 40, 37, 4), (3, 48, 136, 130, 8),
                                            (2, 16, 16, 64, 8)])
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


def test_wrappers_reject_bad_inputs():
    x, scale, bias, w, bb = _inputs(4, 2, 16, 32, 16)
    with pytest.raises(ValueError):
        group_norm.group_norm_silu(x.transpose(1, 2), scale, bias, 4)
    with pytest.raises(ValueError):
        group_norm.group_norm_silu(x, scale.double(), bias, 4)
    with pytest.raises(ValueError):
        fused_resblock.gn_silu_conv3(x, scale, bias, w.bfloat16(), bb, 4)
    with pytest.raises(ValueError):
        fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 3)


def test_launch_counters_count_kernel_launches():
    group_norm.reset_counts()
    fused_resblock.reset_counts()
    x, scale, bias, w, bb = _inputs(5, 2, 16, 32, 16)
    group_norm.group_norm_silu(x, scale, bias, 4)
    fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 4)
    fused_resblock.gn_silu_conv3(x, scale, bias, w, bb, 4)
    group_norm.group_norm_silu(x.cpu(), scale.cpu(), bias.cpu(), 4)  # plain: not counted
    assert group_norm.launches == 1
    assert fused_resblock.launches == 2
    assert fused_resblock.launch_shapes[(2, 16, 16, 32, 4, "torch.float32")] == 2
