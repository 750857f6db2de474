"""K2's bf16 formulation, checked on the CPU before the card runs it.

The bf16 kernel reads the weight as ``conv_tiles(w)`` (tap-major tiles of
128 output x 64 input channels, zero padded, each row's 16-byte chunks
swizzled) and computes y[l] = sum_k h[l + k - 1] @ W_k^T over positions,
with h zero outside [0, L), in (B, L, C). That sum, written here in plain
torch on the taps read back from the wrapper's own re-layout, must equal
the port's plain version
``gn_silu_conv3_reference`` and the JAX package's Pallas
``fused_gn_silu_conv3`` (interpret mode, as tests/test_pallas_kernels.py
runs it) in fp32 at rtol 1e-5 / atol 1e-5: a tap taken with the wrong
sign of its shift, or a transposed weight, fails here. The kernel's SiLU,
u + u tanh(u) for u = v / 2, and the cache of re-layouts are checked too.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sleepgen.pallas_kernels.fused_resblock import fused_gn_silu_conv3
from sleepgen_torch.kernels import fused_resblock
from sleepgen_torch.kernels.group_norm import group_norm_silu_reference
from sleepgen_torch.utils import profiling


def _taps(tiles):
    """(3, NT 128, NK 64) padded taps read back from conv_tiles: chunk j of
    row n is stored at chunk j ^ (n % 8), and the XOR is its own inverse."""
    nt, nk = tiles.shape[:2]
    t = tiles.reshape(nt, nk, 3, 128, 8, 8)
    row = torch.arange(128)[:, None]
    t = t[:, :, :, row, torch.arange(8) ^ (row % 8)]
    return t.permute(2, 0, 3, 1, 4, 5).reshape(3, nt * 128, nk * 64)


def _taps_conv(x_bcl, scale, bias, w, b, num_groups):
    """GroupNorm -> SiLU, then sum_k shift(h, k - 1) @ W_k^T over (B, L, C)."""
    h = group_norm_silu_reference(x_bcl, scale, bias, num_groups).transpose(1, 2)
    taps = _taps(fused_resblock.conv_tiles(w))
    l = h.shape[1]
    hp = F.pad(h, (0, taps.shape[-1] - h.shape[-1], 1, 1))  # C_in padded; one zero row each side
    y = sum(hp[:, k:k + l] @ taps[k].T for k in range(3))
    return (y[..., :w.shape[0]] + b).transpose(1, 2)


# (B, L, C_in, C_out, G): tests/test_pallas_kernels.py's shapes and a ragged
# one (C_in not a multiple of 8, L odd)
@pytest.mark.parametrize("b,l,cin,cout,g", [(2, 96, 32, 64, 32), (3, 64, 16, 16, 8),
                                            (2, 128, 32, 32, 1), (2, 37, 12, 20, 4)])
def test_conv_taps_sum_matches_plain_and_pallas(b, l, cin, cout, g):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, l, cin)).astype(np.float32)
    scale = rng.normal(size=cin).astype(np.float32)
    bias = rng.normal(size=cin).astype(np.float32)
    w = (rng.normal(size=(3, cin, cout)) * 0.1).astype(np.float32)  # JAX (3, C_in, C_out)
    bb = rng.normal(size=cout).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))),
            torch.from_numpy(scale), torch.from_numpy(bias),
            torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))),  # (C_out, C_in, 3)
            torch.from_numpy(bb)]
    got = _taps_conv(*args, g).numpy()
    plain = fused_resblock.gn_silu_conv3_reference(*args, g).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(fused_gn_silu_conv3(*(jnp.asarray(a) for a in (x, scale, bias, w, bb)),
                                            g, interpret=True))
    np.testing.assert_allclose(got, pallas.transpose(0, 2, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cout,cin", [(24, 8), (24, 12), (128, 64), (136, 96), (512, 1024)])
def test_conv_tiles_layout(cout, cin):
    w = torch.randn(cout, cin, 3)
    tiles = fused_resblock.conv_tiles(w)
    nt, nk = -(-cout // 128), -(-cin // 64)
    assert tiles.shape == (nt, nk, 3, 128, 64) and tiles.is_contiguous()
    taps = _taps(tiles)
    for k in range(3):
        assert torch.equal(taps[k, :cout, :cin], w[:, :, k])
    assert not taps[:, cout:].any() and not taps[:, :, cin:].any()
    # the swizzle itself: row 5's chunk 0 (channels 0-7) is stored at chunk 5
    assert torch.equal(tiles[0, 0, 1, 5, 40:48], w[5, 0:8, 1])


def test_kernel_silu_form_equals_silu():
    """The kernel's SiLU: u + u tanh(u) with u = v / 2 (one tanh)."""
    v = torch.linspace(-20, 20, 4001, dtype=torch.float64)
    u = v / 2
    torch.testing.assert_close(u + u * torch.tanh(u), F.silu(v), rtol=1e-12, atol=1e-12)


def test_tiles_cache_follows_the_weight():
    """An fp32 weight's entry holds the fp32 kernel's layout."""
    w = torch.randn(16, 24, 3)
    first = fused_resblock._cached_tiles(w)
    assert fused_resblock._cached_tiles(w) is first
    w.mul_(2.0)  # in place: the version moves, the entry is stale
    again = fused_resblock._cached_tiles(w)
    assert again is not first and torch.equal(again, fused_resblock.fp32_conv_tiles(w))
    key = id(w)
    del w
    gc.collect()
    assert key not in fused_resblock._tiles_cache
    with torch.inference_mode():
        wi = torch.randn(16, 24, 3)
        assert torch.equal(fused_resblock._cached_tiles(wi), fused_resblock.fp32_conv_tiles(wi))
    assert id(wi) not in fused_resblock._tiles_cache


def test_tiles_cache_keys_the_master_weight():
    """An fp32 master read for the bf16 kernel, as the trainer's eval and
    in-training sample do under inference mode: one re-layout per weight
    and version, equal to the tiles of the weight rounded to bf16."""
    w = torch.randn(16, 24, 3)
    profiling.reset()
    with torch.inference_mode():
        tiles = [fused_resblock._cached_tiles(w, torch.bfloat16) for _ in range(3)]
    assert profiling.counters()["k2.relayouts"] == 1 and all(t is tiles[0] for t in tiles)
    assert tiles[0].dtype == torch.bfloat16
    assert torch.equal(tiles[0], fused_resblock.conv_tiles(w.bfloat16()))
    assert fused_resblock._cached_tiles(w) is not tiles[0]  # fp32 tiles: their own entry
    w.add_(1.0)
    with torch.inference_mode():
        fused_resblock._cached_tiles(w, torch.bfloat16)
    assert profiling.counters()["k2.relayouts"] == 3
