"""The port's int8 sampling path against the JAX package's, on the CPU.

``quantize_kernel_per_cout`` exactly; ``QuantConv1d``'s int32 accumulators
exactly equal to JAX's ``lax.dot_general`` on the same int8 inputs (its
padded k C_in = 3 and C_out = 1 cases included) and its output at fp32
rounding; the quantized tiny UNet (model_channels 16, channel_mult (1, 2),
attention at ds 2, G 8, one channel, latent 64) against JAX's quantized
UNet and against the fp32 UNet at tests/test_quant.py's bound (relative L2
below 0.05); ``sample_ldm_trials(quantized=True)`` against JAX's on the
same x_T (DDIM-4, AEKL [4, 4, 8], fp32) at the same bound. Weights are
drawn from numpy and carried over with ``sleepgen_torch.utils.weights``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.config import Config as JaxConfig
from sleepgen.nn import AutoencoderKL as JaxAEKL
from sleepgen.nn import UNet1d as JaxUNet
from sleepgen.nn.quant import QuantConv1d as JaxQuantConv1d
from sleepgen.nn.quant import quantize_kernel_per_cout as jax_quantize_kernel
from sleepgen.nn.quant import quantize_unet_params as jax_quantize_unet_params
from sleepgen.sample import samplers as jax_samplers
from sleepgen.sample.sample_ldm import sample_ldm_trials as jax_sample_ldm_trials
from sleepgen.utils import jit_init
from sleepgen_torch.config import Config
from sleepgen_torch.nn import quant
from sleepgen_torch.nn.unet1d import UNet1d, quantize_unet
from sleepgen_torch.sample import sample_ldm
from sleepgen_torch.utils import weights

from test_torch_port_parity import _randomize

REL_L2 = 0.05  # tests/test_quant.py's bound
UNET_KW = dict(in_channels=1, out_channels=1, model_channels=16, channel_mult=(1, 2),
               num_res_blocks=2, attention_resolutions=(2,), num_groups=8)
LATENT = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: its models are tiny,
    and the suite runs several worker processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_quantize_kernel_per_cout_matches_jax_exactly():
    rng = np.random.default_rng(0)
    for shape in ((3, 8, 16), (1, 32, 96), (3, 1, 16), (3, 16, 1)):
        w = (rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])).astype(np.float32)
        w[..., 0] = 0.0  # an all-zero output channel: the 1e-12 floor
        want = jax_quantize_kernel(w)
        got = quant.quantize_kernel_per_cout(w.transpose(2, 1, 0))
        assert got["weight_q"].dtype == np.int8
        np.testing.assert_array_equal(got["weight_q"].transpose(2, 1, 0), want["kernel_q"])
        np.testing.assert_array_equal(got["weight_scale"], want["kernel_scale"])


def _jax_accumulators(xq, wq):
    """JAX's QuantConv1d product on int8 inputs: pad, stack the k taps along
    the channels, one int32 dot_general. xq (B, L, C_in), wq (k, C_in, C_out)."""
    b, l, cin = xq.shape
    k, _, cout = wq.shape
    x = jnp.asarray(xq)
    if k > 1:
        xp = jnp.pad(x, ((0, 0), (k // 2, k // 2), (0, 0)))
        x = jnp.concatenate([xp[:, d:d + l, :] for d in range(k)], axis=-1)
    return np.asarray(jax.lax.dot_general(
        x, jnp.asarray(wq).reshape(k * cin, cout), (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("k,cin,cout", [(3, 1, 16), (3, 8, 1), (1, 8, 24), (3, 16, 32),
                                        (1, 3, 9)])
def test_int32_accumulators_equal_jax(k, cin, cout):
    """Exactly, including the padded cases: k C_in = 3 (conv_in on a
    one-channel latent) and C_out = 1 (conv_out), and odd sizes."""
    rng = np.random.default_rng(k * 100 + cin + cout)
    b, l = 2, 40
    xq = rng.integers(-127, 128, size=(b, l, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, cin, cout)).astype(np.int8)
    want = _jax_accumulators(xq, wq)
    got = quant.int8_conv_accumulate(_t(xq.transpose(0, 2, 1)),
                                     quant.weight_matrix(_t(wq.transpose(2, 1, 0))), k, cout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,cin,cout", [(3, 1, 16), (3, 16, 1), (1, 8, 24)])
def test_quant_conv_matches_jax(k, cin, cout):
    rng = np.random.default_rng(7 + k + cin)
    w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    q = jax_quantize_kernel(w)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    x = rng.standard_normal((2, 48, cin)).astype(np.float32)
    want = JaxQuantConv1d(cout, k, dtype=jnp.float32).apply(
        {"params": {"kernel_q": q["kernel_q"], "kernel_scale": q["kernel_scale"],
                    "bias": bias}}, jnp.asarray(x))
    m = quant.QuantConv1d(cin, cout, k)
    m.load_state_dict({"weight_q": _t(q["kernel_q"].transpose(2, 1, 0)),
                       "weight_scale": _t(q["kernel_scale"]), "bias": _t(bias)})
    with torch.no_grad():
        got = m(_t(x.transpose(0, 2, 1)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def unets():
    """JAX UNet params (numpy-drawn), and the JAX fp32 and quantized
    outputs on one input."""
    m = JaxUNet(**UNET_KW)
    params = _randomize(jit_init(m, jax.random.PRNGKey(0), jnp.zeros((2, LATENT, 1)),
                                 jnp.zeros((2,), jnp.int32))["params"], 70)
    x = np.random.default_rng(71).normal(size=(2, LATENT, 1)).astype(np.float32)
    t = np.array([100, 900], np.int32)
    ref = np.asarray(m.apply({"params": params}, x, t))
    qm = JaxUNet(**UNET_KW, quantized=True, dtype=jnp.float32)
    qparams = jax_quantize_unet_params(params)
    return dict(params=params, qparams=qparams, x=x, t=t, ref=ref,
                qref=np.asarray(qm.apply({"params": qparams}, x, t)))


def test_quantize_unet_params_matches_jax(unets):
    """Every convolution quantized as JAX quantizes it; the rest unchanged."""
    state = weights.unet_state_from_jax(unets["params"])
    got = quant.quantize_unet_params(state)
    qtree = unets["qparams"]
    n_conv = 0
    for name, v in state.items():
        if name.endswith(".weight") and v.ndim == 3:
            n_conv += 1
            assert name not in got
            assert got[name[:-6] + "weight_q"].dtype == np.int8
        else:
            np.testing.assert_array_equal(got[name], v)
    conv_in = qtree["conv_in"]
    np.testing.assert_array_equal(got["input_blocks.0.0.weight_q"].transpose(2, 1, 0),
                                  conv_in["kernel_q"])
    np.testing.assert_array_equal(got["input_blocks.0.0.weight_scale"], conv_in["kernel_scale"])
    qkv = qtree["mid_attn"]["SelfAttention1d_0"]["qkv"]
    np.testing.assert_array_equal(got["middle_block.1.qkv.weight_q"].transpose(2, 1, 0),
                                  qkv["kernel_q"])
    assert n_conv == sum(k.endswith("weight_q") for k in got)


def test_quantized_unet_matches_jax(unets):
    fp = weights.load_numpy_state(UNet1d(**UNET_KW).eval(),
                                  weights.unet_state_from_jax(unets["params"]))
    q = UNet1d(**UNET_KW, quantized=True).eval()
    weights.load_numpy_state(q, quant.quantize_unet_params(fp.state_dict()))
    assert all(isinstance(m, quant.QuantConv1d) for m in (
        q.input_blocks[0][0], q.out["2"], q.middle_block[0].in_layers["2"],
        q.middle_block[1].qkv, q.middle_block[1].proj_out))
    x, t = _t(unets["x"].transpose(0, 2, 1)), _t(unets["t"]).long()
    with torch.no_grad():
        got = q(x, t).numpy().transpose(0, 2, 1)
        copy = quantize_unet(fp)(x, t).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(copy, got)
    assert float(np.abs(unets["qref"]).mean()) > 0.1
    assert _rel(got, unets["qref"]) < REL_L2, _rel(got, unets["qref"])
    assert _rel(got, unets["ref"]) < REL_L2, _rel(got, unets["ref"])


def _tiny_configs():
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.dtype = "float32"
        c.unet.model_channels, c.unet.channel_mult = 16, [1, 2]
        c.unet.attention_resolutions, c.unet.norm_num_groups = [2], 8
        c.unet.image_size = LATENT
        c.aekl.num_channels = [4, 4, 8]
        c.diffusion.num_inference_steps = 4
    return jcfg, cfg


def test_sample_ldm_trials_quantized_matches_jax(unets, monkeypatch, tmp_path):
    jcfg, cfg = _tiny_configs()
    ae = JaxAEKL(num_channels=(4, 4, 8), latent_channels=1)
    rng = jax.random.PRNGKey(1)
    ae_params = _randomize(jit_init(ae, {"params": rng}, jnp.zeros((1, 4 * LATENT, 1)), rng)
                           ["params"], 72)
    key = jax.random.PRNGKey(5)
    kw = dict(start_seed=0, stop_seed=3, batch_size=2, compute_psd=False)
    want = jax_sample_ldm_trials(jcfg, unets["params"], ae_params, 1.3, tmp_path / "jax",
                                 base_key=key, quantized=True, **kw)
    monkeypatch.setattr(sample_ldm, "seed_noise", lambda seeds, shape, dev: _t(
        jax_samplers.seed_noise(key, jnp.asarray(seeds), shape)))
    got = sample_ldm.sample_ldm_trials(cfg, weights.unet_state_from_jax(unets["params"]),
                                       weights.aekl_state_from_jax(ae_params), 1.3,
                                       tmp_path / "port", device="cpu", quantized=True, **kw)
    assert got.shape == want.shape == (3, 4 * LATENT - 72, 1)
    assert float(np.abs(want).mean()) > 0.01
    assert _rel(got, want) < REL_L2, _rel(got, want)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        f"sample_{i}.npy" for i in range(3)]


def test_quant_conv_built_under_inference_mode():
    """A QuantConv1d made under ``torch.inference_mode`` (its buffers then
    have no version counter) lays out its weight matrix on every call."""
    rng = np.random.default_rng(12)
    w = jax_quantize_kernel((rng.standard_normal((3, 4, 8)) / 4).astype(np.float32))
    x = _t(rng.standard_normal((2, 4, 20)).astype(np.float32))
    state = {"weight_q": _t(w["kernel_q"].transpose(2, 1, 0)),
             "weight_scale": _t(w["kernel_scale"]), "bias": torch.zeros(8)}
    m = quant.QuantConv1d(4, 8, 3)
    m.load_state_dict(state)
    with torch.inference_mode():
        made = quant.QuantConv1d(4, 8, 3)
        made.load_state_dict(state)
        assert made.weight_q.is_inference()
        torch.testing.assert_close(made(x), m(x), rtol=0, atol=0)

