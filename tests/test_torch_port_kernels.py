"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors the wrappers run their plain PyTorch versions; these are
held to the Pallas kernels (interpret mode) and to the jnp references at
the bounds of tests/test_pallas_kernels.py: K1 rtol 1e-5 / atol 2e-6,
K2 rtol 2e-4 / atol 2e-4. Inputs are made with numpy from a seed; the JAX
side takes them in (B, L, C), the port in (B, C, L).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.pallas_kernels import fused_group_norm_silu, group_norm_silu_reference
from sleepgen.pallas_kernels.fused_resblock import (fused_gn_silu_conv3_tiled,
                                                    gn_silu_conv3_reference)
from sleepgen_torch.kernels import fused_resblock, group_norm
from sleepgen_torch.utils import profiling


def _bcl(x_blc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_blc.transpose(0, 2, 1)))


def _blc(y_bcl: torch.Tensor) -> np.ndarray:
    return y_bcl.numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("num_groups", [1, 4, 16])
@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_silu_plain_matches_pallas(num_groups, apply_silu):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    got = _blc(group_norm.group_norm_silu(_bcl(x), torch.from_numpy(scale),
                                          torch.from_numpy(bias), num_groups, 1e-6,
                                          apply_silu))
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), num_groups, 1e-6,
            apply_silu)
    for want in (fused_group_norm_silu(*args), group_norm_silu_reference(*args)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=2e-6)
    assert profiling.counters()["k1.launches"] == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("b,l,cin,cout,g,tb", [(8, 96, 32, 64, 32, 4),
                                               (6, 64, 16, 16, 8, 4),
                                               (4, 128, 32, 32, 1, 8)])
def test_gn_silu_conv3_plain_matches_pallas(b, l, cin, cout, g, tb):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, l, cin)).astype(np.float32)
    scale = rng.normal(size=cin).astype(np.float32)
    bias = rng.normal(size=cin).astype(np.float32)
    w = (rng.normal(size=(3, cin, cout)) * 0.1).astype(np.float32)  # JAX (3, C_in, C_out)
    bb = rng.normal(size=cout).astype(np.float32)
    got = _blc(fused_resblock.gn_silu_conv3(
        _bcl(x), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))),
        torch.from_numpy(bb), g))
    assert got.shape == (b, l, cout)
    jargs = [jnp.asarray(a) for a in (x, scale, bias, w, bb)]
    for want in (fused_gn_silu_conv3_tiled(*jargs, g, interpret=True, tb=tb),
                 gn_silu_conv3_reference(*jargs, g)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    assert profiling.counters()["k2.launches"] == 0
