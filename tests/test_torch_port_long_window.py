"""The long-window attention contract (``kv_block_size``) against the JAX
package, on the CPU in fp32.

The JAX UNet computes attention blockwise (an online softmax over KV
blocks) when ``kv_block_size`` is set and the attention length exceeds it,
and refuses a block that does not divide that length. The port computes
the same softmax with one ``scaled_dot_product_attention`` and refuses the
same blocks, with JAX's exception type and message, before it runs
anything. A tiny UNet (model_channels 8, channel_mult (1, 2), attention at
ds 2, G 4, one channel) on a window of 6144 samples attends over 3072
tokens, as ``benches/long_window.py``'s default UNet does at window
12288: with block 512 the port holds to JAX at the model bound of
tests/test_torch_import.py (rtol 2e-3 / atol 2e-4) and equals itself
without blocks; with block 1000 both refuse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.config import Config as JaxConfig
from sleepgen.nn import UNet1d as JaxUNet
from sleepgen.nn.layers import SelfAttention1d as JaxSelfAttention
from sleepgen.train.train_ldm import build_unet as jax_build_unet
from sleepgen.utils import jit_init
from sleepgen_torch.config import Config
from sleepgen_torch.nn.layers import check_kv_block
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.sample.sample_ldm import build_unet
from sleepgen_torch.utils import weights

from test_torch_port_parity import _randomize

RTOL, ATOL = 2e-3, 2e-4
WINDOW, TOKENS, BLOCK, BAD_BLOCK = 6144, 3072, 512, 1000
UNET_KW = dict(in_channels=1, out_channels=1, model_channels=8, channel_mult=(1, 2),
               attention_resolutions=(2,), num_groups=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: the suite runs several
    worker processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def params():
    m = JaxUNet(**UNET_KW)
    return _randomize(jit_init(m, jax.random.PRNGKey(0), jnp.zeros((1, 64, 1)),
                               jnp.zeros((1,), jnp.int32))["params"], 60)


@pytest.fixture(scope="module")
def inputs():
    x = np.random.default_rng(61).normal(size=(1, WINDOW, 1)).astype(np.float32)
    return x, np.array([321], np.int32)


def _port(params, block):
    return weights.load_numpy_state(UNet1d(**UNET_KW, kv_block_size=block).eval(),
                                    weights.unet_state_from_jax(params))


def _jax_error(fn) -> AssertionError:
    with pytest.raises(AssertionError) as info:
        fn()
    return info.value


def test_unet_refuses_a_block_that_does_not_divide_as_jax_does(params, inputs):
    x, t = inputs
    want = _jax_error(lambda: JaxUNet(**UNET_KW, kv_block_size=BAD_BLOCK).apply(
        {"params": params}, x, t))
    port = _port(params, BAD_BLOCK)
    calls = []
    for m in port.modules():
        m.register_forward_pre_hook(lambda mod, args: calls.append(type(mod).__name__))
    with pytest.raises(AssertionError) as info:
        with torch.no_grad():
            port(_t(x.transpose(0, 2, 1)), _t(t).long())
    assert str(info.value) == str(want)
    assert f"L={TOKENS}" in str(want)
    assert calls == ["UNet1d"]  # refused before any layer ran


@pytest.mark.parametrize("length,refused", [(96, True), (80, False), (32, False)])
def test_block_rule_is_jax_self_attention_rule(length, refused):
    """``check_kv_block`` refuses where JAX's SelfAttention1d with
    ``kv_block_size`` 40 refuses (96 tokens), with its message, and passes
    a length the block divides (80) or that does not exceed it (32)."""
    x = np.random.default_rng(62).normal(size=(1, length, 8)).astype(np.float32)
    jm = JaxSelfAttention(num_heads=2, zero_out=False, kv_block_size=40)
    variables = jit_init(jm, jax.random.PRNGKey(1), jnp.zeros((1, 80, 8)))
    if not refused:
        jm.apply(variables, x)
        check_kv_block(length, 40)
        return
    want = _jax_error(lambda: jm.apply(variables, x))
    with pytest.raises(AssertionError) as info:
        check_kv_block(length, 40)
    assert str(info.value) == str(want)


def test_build_unet_passes_the_block_through():
    """``cfg.unet.kv_block_size`` reaches the UNet: a block that does not
    divide the attention length is refused by the port as by JAX."""
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.unet.model_channels, c.unet.channel_mult = 8, [1, 2]
        c.unet.attention_resolutions, c.unet.norm_num_groups = [2], 4
        c.unet.kv_block_size = BAD_BLOCK
    unet = build_unet(cfg, 1, 1)
    assert unet.kv_block_size == BAD_BLOCK
    jm = jax_build_unet(jcfg, 1, 1, jnp.float32)
    assert jm.kv_block_size == BAD_BLOCK
    x = np.zeros((1, WINDOW, 1), np.float32)
    t = np.zeros((1,), np.int32)
    variables = jit_init(jm, jax.random.PRNGKey(0), jnp.zeros((1, 64, 1)),
                         jnp.zeros((1,), jnp.int32))
    want = _jax_error(lambda: jm.apply(variables, x, t))
    with pytest.raises(AssertionError) as info:
        with torch.no_grad():
            unet(_t(x.transpose(0, 2, 1)), _t(t).long())
    assert str(info.value) == str(want)


def test_long_window_matches_jax_blockwise(params, inputs):
    """3072 attention tokens, block 512: JAX's blockwise attention against
    the port's, which also equals the port without blocks exactly."""
    x, t = inputs
    want = np.asarray(jax.jit(JaxUNet(**UNET_KW, kv_block_size=BLOCK).apply)(
        {"params": params}, x, t))
    with torch.no_grad():
        got = _port(params, BLOCK)(_t(x.transpose(0, 2, 1)), _t(t).long())
        full = _port(params, 0)(_t(x.transpose(0, 2, 1)), _t(t).long())
    torch.testing.assert_close(got, full, rtol=0, atol=0)
    assert float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, rtol=RTOL, atol=ATOL)
