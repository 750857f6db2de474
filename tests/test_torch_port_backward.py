"""The port's GroupNorm backward and the B2/B3 entry points against the JAX
package, on the CPU.

On CPU tensors the wrappers run their plain versions. The backward (K3's
plain closed form, through ``group_norm_silu``'s autograd Function and
called directly) is held to ``jax.grad`` of the Pallas
``fused_group_norm_silu`` in interpret mode (its own VJP) and to
``sleepgen.nn.fused_norm._bwd``, at the gradient bound of
tests/test_pallas_kernels.py (rtol 1e-4 / atol 1e-5). B2 is held to the
Pallas ``group_norm_silu_tiled`` at 2e-5 and B3 to the Pallas
``fused_gn_silu_conv3`` at 2e-4, at the shapes of that file. Inputs are
made with numpy from a seed; JAX takes (B, L, C), the port (B, C, L).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.nn import fused_norm
from sleepgen.pallas_kernels import fused_group_norm_silu, group_norm_silu_tiled
from sleepgen.pallas_kernels.fused_resblock import fused_gn_silu_conv3
from sleepgen_torch.kernels import fused_resblock, group_norm
from sleepgen_torch.utils import profiling


def _bcl(x_blc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x_blc).transpose(0, 2, 1)))


def _blc(y_bcl: torch.Tensor) -> np.ndarray:
    return y_bcl.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("num_groups", [1, 4, 16])
@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_backward_matches_jax(num_groups, apply_silu):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 48, 16)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.normal(size=16)).astype(np.float32)
    bias = (0.2 * rng.normal(size=16)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def loss(xx, ss, bb):
        y = fused_group_norm_silu(xx, ss, bb, num_groups, 1e-6, apply_silu)
        return jnp.sum(y * dy)

    want_pallas = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                                    jnp.asarray(bias))
    _, res = fused_norm._fwd(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                             num_groups, 1e-6, apply_silu, None)
    want_closed = fused_norm._bwd(num_groups, 1e-6, apply_silu, None, res, jnp.asarray(dy))

    xt = _bcl(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = group_norm.group_norm_silu(xt, st, bt, num_groups, 1e-6, apply_silu)
    y.backward(_bcl(dy))
    via_autograd = (_blc(xt.grad), st.grad.numpy(), bt.grad.numpy())
    stats = group_norm.group_stats_reference(xt.detach(), num_groups)
    dx, dscale, dbias = group_norm.group_norm_silu_backward_reference(
        xt.detach(), _bcl(dy), st.detach(), bt.detach(), stats, num_groups, apply_silu)
    direct = (_blc(dx), dscale.numpy(), dbias.numpy())
    for got in (via_autograd, direct):
        for g, w1, w2 in zip(got, want_pallas, want_closed):
            np.testing.assert_allclose(g, np.asarray(w1), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g, np.asarray(w2), rtol=1e-4, atol=1e-5)
    assert profiling.counters()["k3.launches"] == 0  # CPU tensors never reach K3


def test_group_norm_backward_keeps_dtype_and_needs():
    """dx has x's dtype, the parameter gradients are fp32, and only the
    inputs that require grad get one."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(2, 8, 12)).astype(np.float32)).bfloat16()
    x.requires_grad_()
    scale, bias = torch.ones(8), torch.zeros(8, requires_grad=True)
    group_norm.group_norm_silu(x, scale, bias, 2).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and bias.grad.dtype == torch.float32
    assert scale.grad is None


@pytest.mark.parametrize("b,l,c,g,tile", [(2, 1024, 32, 1, 256), (2, 512, 64, 8, 128)])
def test_group_norm_tiled_matches_pallas(b, l, c, g, tile):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(b, l, c)).astype(np.float32)
    scale = (rng.normal(size=c) + 1.0).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    want = group_norm_silu_tiled(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), g,
                                 tile=tile)
    got = group_norm.group_norm_silu_tiled(_bcl(x), torch.from_numpy(scale),
                                           torch.from_numpy(bias), g, tile=tile)
    np.testing.assert_allclose(_blc(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="tile"):
        group_norm.group_norm_silu_tiled(_bcl(x), torch.from_numpy(scale),
                                         torch.from_numpy(bias), g, tile=0)


@pytest.mark.parametrize("b,l,cin,cout,g", [(2, 96, 32, 64, 32), (3, 64, 16, 16, 8),
                                            (2, 128, 32, 32, 1)])
def test_fused_gn_silu_conv3_matches_pallas(b, l, cin, cout, g):
    rng = np.random.default_rng(14)
    x = rng.normal(size=(b, l, cin)).astype(np.float32)
    scale = rng.normal(size=cin).astype(np.float32)
    bias = rng.normal(size=cin).astype(np.float32)
    w = (rng.normal(size=(3, cin, cout)) * 0.1).astype(np.float32)
    bb = rng.normal(size=cout).astype(np.float32)
    want = fused_gn_silu_conv3(*[jnp.asarray(a) for a in (x, scale, bias, w, bb)], g,
                               interpret=True)
    got = fused_resblock.fused_gn_silu_conv3(
        _bcl(x), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))), torch.from_numpy(bb), g)
    assert got.shape == (b, cout, l)
    np.testing.assert_allclose(_blc(got), np.asarray(want), rtol=2e-4, atol=2e-4)
