"""The UNet's and the AEKL's options, and the precision switches, against
the JAX package on the CPU.

Tiny widths: UNet1d model_channels 32, channel_mult (1, 2), attention at
ds 2, G 8, latent 64; AutoencoderKL [4, 4, 8], latent 1, windows of 256.
Every weight leaf of the JAX modules is drawn from numpy and carried into
the port with ``sleepgen_torch.utils.weights``. Bounds: fp32, the model
bound of tests/test_torch_import.py (rtol 2e-3 / atol 2e-4). In bf16 the
precision switches are held two ways: the port's strict attention is the
fp32 computation on the bf16 inputs rounded once (within one bf16 step of
the output, 2^-7 relative), and the whole strict UNet stays within atol
0.05 of JAX's strict UNet, about 2.5 times what bf16 rounding alone moves
either package's output from fp32 at these widths (0.013-0.020).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sleepgen.nn import AutoencoderKL as JaxAEKL
from sleepgen.nn import UNet1d as JaxUNet
from sleepgen.nn.layers import SelfAttention1d as JaxSelfAttention
from sleepgen.utils import jit_init
from sleepgen_torch.config import Config
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.layers import SelfAttention1d, attention, cast_compute_dtype
from sleepgen_torch.nn.unet1d import Downsample, UNet1d
from sleepgen_torch.train import train_ldm as T
from sleepgen_torch.utils import weights

from test_torch_port_parity import AEKL_CH, ATOL, LATENT, RTOL, UNET_KW, _randomize

BF16_UNET_ATOL = 0.05

OPTIONS = {
    "scale_shift": dict(use_scale_shift_norm=True),
    "conv_resample": dict(resblock_updown=False),
    "pool_resample": dict(resblock_updown=False, conv_resample=False),
    "dropout": dict(dropout=0.1),
    "all": dict(use_scale_shift_norm=True, resblock_updown=False, dropout=0.1),
}
AEKL_OPTIONS = {
    "attention_level": dict(attention_levels=(False, False, True)),
    "encoder_nonlocal": dict(with_encoder_nonlocal_attn=True),
    "decoder_nonlocal": dict(with_decoder_nonlocal_attn=True),
    "all": dict(attention_levels=(True, False, True), with_encoder_nonlocal_attn=True,
                with_decoder_nonlocal_attn=True),
}


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


def _bcl(a):
    return _t(np.asarray(a).transpose(0, 2, 1))


@pytest.fixture(scope="module")
def unets():
    """name -> (JAX module, its numpy params) for each option set."""
    out = {}
    for i, (name, opts) in enumerate(OPTIONS.items()):
        m = JaxUNet(num_groups=8, **UNET_KW, **opts)
        p = jit_init(m, jax.random.PRNGKey(0), jnp.zeros((2, LATENT, 1)),
                     jnp.zeros((2,), jnp.int32))["params"]
        out[name] = (m, _randomize(p, 50 + i))
    return out


@pytest.fixture(scope="module")
def aekls():
    out = {}
    for i, (name, opts) in enumerate(AEKL_OPTIONS.items()):
        m = JaxAEKL(num_channels=AEKL_CH, latent_channels=1, **opts)
        rng = jax.random.PRNGKey(1)
        p = jit_init(m, {"params": rng}, jnp.zeros((1, 4 * LATENT, 1)), rng)["params"]
        out[name] = (m, _randomize(p, 60 + i))
    return out


def _port_unet(name, params, **kw):
    m = UNet1d(num_groups=8, **UNET_KW, **OPTIONS[name], **kw).eval()
    return weights.load_numpy_state(m, weights.unet_state_from_jax(params))


def _unet_inputs():
    x = np.random.default_rng(1).normal(size=(2, LATENT, 1)).astype(np.float32)
    return x, np.array([17, 931], np.int32)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_unet_option_matches_jax(unets, name):
    jm, params = unets[name]
    x, t = _unet_inputs()
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = _port_unet(name, params)(_bcl(x), _t(t))
    assert float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, rtol=RTOL, atol=ATOL)


def test_unet_option_names_are_the_reference_unets():
    """resblock_updown=False: a Downsample's conv is input_blocks.N.0.op, an
    Upsample's output_blocks.N.M.conv; scale-shift doubles emb_layers.1."""
    sd = UNet1d(num_groups=8, **UNET_KW, resblock_updown=False,
                use_scale_shift_norm=True).state_dict()
    assert "input_blocks.3.0.op.weight" in sd and "output_blocks.2.2.conv.weight" in sd
    assert sd["input_blocks.1.0.emb_layers.1.weight"].shape == (2 * 32, 4 * 32)
    pooled = UNet1d(num_groups=8, **UNET_KW, resblock_updown=False, conv_resample=False)
    assert not any(k.startswith("input_blocks.3.") for k in pooled.state_dict())


@pytest.mark.parametrize("length", [64, 65])
def test_downsample_pads_as_flax_same(length):
    """The stride-2 downsample pads (0, 1) on an even length, flax's SAME
    (torch's padding=1 would shift every output by one tap), and (1, 1) on
    an odd one; against flax's Conv on the same weights."""
    from sleepgen.nn.layers import conv1d as jax_conv1d

    c = 4
    x = np.random.default_rng(length).normal(size=(2, length, c)).astype(np.float32)
    jm = jax_conv1d(c, 3, stride=2)
    p = _randomize(jit_init(jm, jax.random.PRNGKey(2), jnp.asarray(x))["params"], 3)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    down = Downsample(c)
    sd = {}
    weights._conv(sd, "op", p)
    weights.load_numpy_state(down, sd)
    with torch.no_grad():
        got = down(_bcl(x)).numpy().transpose(0, 2, 1)
        torch_pad = F.conv1d(_bcl(x), down.op.weight, down.op.bias, stride=2, padding=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if length % 2 == 0:
        assert np.abs(torch_pad.numpy().transpose(0, 2, 1) - want).max() > 1e-2


@pytest.mark.parametrize("name", list(AEKL_OPTIONS))
def test_aekl_attention_matches_jax(aekls, name):
    jm, params = aekls[name]
    v = {"params": params}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4 * LATENT, 1)).astype(np.float32)
    z = rng.normal(size=(2, LATENT, 1)).astype(np.float32)
    mu_j, sigma_j = jax.jit(lambda a: jm.apply(v, a, method=JaxAEKL.encode))(x)
    dec_j = jax.jit(lambda a: jm.apply(v, a, method=JaxAEKL.decode))(z)
    pm = weights.load_numpy_state(
        AutoencoderKL(num_channels=AEKL_CH, latent_channels=1, **AEKL_OPTIONS[name]).eval(),
        weights.aekl_state_from_jax(params))
    with torch.no_grad():
        mu, sigma = pm.encode(_bcl(x))
        dec = pm.decode(_bcl(z))
    for got, want in ((mu, mu_j), (sigma, sigma_j), (dec, dec_j)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    assert float(np.abs(np.asarray(dec_j)).mean()) > 0.1


def test_aekl_attention_names_are_monais():
    sd = AutoencoderKL(num_channels=AEKL_CH, **AEKL_OPTIONS["all"]).state_dict()
    for k in ("encoder.blocks.2.to_q.weight", "encoder.blocks.2.proj_attn.bias",
              "decoder.blocks.2.norm.weight", "decoder.blocks.2.to_v.weight"):
        assert k in sd, k
    assert sd["encoder.blocks.2.to_k.weight"].shape == (4, 4)


def _tree_equal(a, b):
    fa = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(a)}
    fb = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(b)}
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_unet_weights_round_trip_exactly(unets, name):
    params = jax.device_get(unets[name][1])
    _tree_equal(weights.unet_state_to_jax(weights.unet_state_from_jax(params)), params)


@pytest.mark.parametrize("name", list(AEKL_OPTIONS))
def test_aekl_weights_round_trip_exactly(aekls, name):
    params = jax.device_get(aekls[name][1])
    _tree_equal(weights.aekl_state_to_jax(weights.aekl_state_from_jax(params)), params)
    sd = weights.seeded_state_dict(AutoencoderKL(num_channels=AEKL_CH, **AEKL_OPTIONS[name]),
                                   7)
    back = weights.aekl_state_from_jax(weights.aekl_state_to_jax(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_stage2_step_with_dropout_matches_jax(unets):
    """One stage-2 step of the UNet with dropout 0.1: loss and every
    gradient against jax.value_and_grad of JAX's step (whose UNet takes no
    dropout key, so dropout is inert there), and bitwise the port's own
    step on the same UNet at dropout 0."""
    from test_torch_port_train import _inputs, _train_schedules

    jm, uparams = unets["dropout"]
    ja = JaxAEKL(num_channels=AEKL_CH, latent_channels=1)
    rng = jax.random.PRNGKey(1)
    aparams = _randomize(jit_init(ja, {"params": rng}, jnp.zeros((1, 4 * LATENT, 1)), rng)
                         ["params"], 31)
    x, enc_eps, noise, t = _inputs()
    sf = 1.3
    js, ps = _train_schedules()

    def loss_fn(p):
        mu, sigma = ja.apply({"params": aparams}, jnp.asarray(x), method=JaxAEKL.encode)
        z = (mu + jnp.asarray(enc_eps) * sigma).astype(jnp.float32) * sf
        noisy = js.add_noise(z, jnp.asarray(noise), jnp.asarray(t))
        pred = jm.apply({"params": p}, noisy, jnp.asarray(t))
        return jnp.mean((pred.astype(jnp.float32) - jnp.asarray(noise)) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(uparams)
    want_grads = weights.unet_state_from_jax(jax.device_get(want_grads))
    ae = weights.load_numpy_state(AutoencoderKL(num_channels=AEKL_CH, latent_channels=1),
                                  weights.aekl_state_from_jax(aparams)).requires_grad_(False)
    runs = {}
    for p in (0.1, 0.0):
        unet = weights.load_numpy_state(UNet1d(num_groups=8, **UNET_KW, dropout=p),
                                        weights.unet_state_from_jax(uparams))
        opt = torch.optim.Adam(unet.parameters(), lr=1e-4)
        loss = T.make_ldm_train_step(unet, ae, ps, opt, sf)(_bcl(x), _t(t).long(), _bcl(noise),
                                                            _bcl(enc_eps))
        runs[p] = (loss, {k: v.grad.clone() for k, v in unet.named_parameters()},
                   {k: v.detach().clone() for k, v in unet.named_parameters()})
    loss, grads, params = runs[0.1]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL, atol=ATOL)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=RTOL, atol=ATOL, err_msg=k)
    assert torch.equal(loss, runs[0.0][0])
    for k in grads:
        assert torch.equal(grads[k], runs[0.0][1][k]), k
        assert torch.equal(params[k], runs[0.0][2][k]), k


def test_strict_attention_is_fp32_math_rounded_once():
    """bf16 q, k and v: the strict path equals the fp32 attention of the
    same bf16 values rounded to bf16 (within one bf16 step); the mixed
    path rounds q and k first and lands further from it."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 3 * 64, 48)).astype(np.float32)).to(torch.bfloat16)
    ref = attention(qkv.float(), 2)
    strict = attention(qkv, 2, mixed_precision=False)
    mixed = attention(qkv, 2, mixed_precision=True)
    assert strict.dtype == mixed.dtype == torch.bfloat16
    err_strict = (strict.float() - ref).abs().max()
    err_mixed = (mixed.float() - ref).abs().max()
    step = 2.0 ** -7 * ref.abs().max()
    assert err_strict <= step
    assert err_mixed > err_strict
    assert torch.equal(attention(qkv.float(), 2, mixed_precision=False), ref)


@pytest.mark.parametrize("heads", [1, 2])
def test_strict_attention_against_jax_in_bf16(heads):
    """JAX's SelfAttention1d and the port's in bf16 on the same bf16 q, k,
    v (projections that permute channels, exact in bf16): each path is
    within one bf16 step of JAX's path of the same name, and strict lies
    closer than mixed to the fp32 result in both packages."""
    b, l, c = 2, 48, 64
    rng = np.random.default_rng(7)
    eye = np.eye(c, dtype=np.float32)
    k3 = np.stack([eye, eye[rng.permutation(c)], eye[rng.permutation(c)]], 1)
    k3 = k3.reshape(c, 3, heads, c // heads).transpose(0, 2, 1, 3).reshape(1, c, 3 * c)
    params = {"qkv": {"kernel": k3, "bias": np.zeros(3 * c, np.float32)},
              "proj_out": {"kernel": eye[None], "bias": np.zeros(c, np.float32)}}
    sd = {}
    weights._conv(sd, "qkv", params["qkv"])
    weights._conv(sd, "proj_out", params["proj_out"])
    x = jnp.asarray(rng.normal(size=(b, l, c)).astype(np.float32), jnp.bfloat16)
    xt = _bcl(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    ref = np.asarray(JaxSelfAttention(heads, zero_out=False).apply({"params": params},
                                                                   x.astype(jnp.float32)))
    err = {}
    for mixed in (False, True):
        jm = JaxSelfAttention(heads, dtype=jnp.bfloat16, zero_out=False, mixed_precision=mixed)
        want = np.asarray(jm.apply({"params": params}, x).astype(jnp.float32))
        pm = weights.load_numpy_state(SelfAttention1d(c, heads, mixed_precision=mixed),
                                      sd).to(torch.bfloat16)
        with torch.no_grad():
            got = pm(xt).float().numpy().transpose(0, 2, 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * np.abs(ref).max())
        err[("port", mixed)] = np.abs(got - ref).max()
        err[("jax", mixed)] = np.abs(want - ref).max()
    assert err[("port", False)] < err[("port", True)]
    assert err[("jax", False)] < err[("jax", True)]


def test_strict_unet_matches_jax_strict_in_bf16():
    """The whole UNet in bf16 with fast_math off in both packages, within
    ``BF16_UNET_ATOL``; the port's mixed UNet gives another output."""
    m = JaxUNet(num_groups=8, dtype=jnp.bfloat16, **UNET_KW)
    params = _randomize(jit_init(m, jax.random.PRNGKey(0), jnp.zeros((2, LATENT, 1)),
                                 jnp.zeros((2,), jnp.int32))["params"], 70)
    x, t = _unet_inputs()
    want = np.asarray(jax.jit(m.clone(fast_math=False).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t)))
    got = {}
    for fast in (False, True):
        pm = UNet1d(num_groups=8, **UNET_KW, fast_math=fast).eval()
        weights.load_numpy_state(pm, weights.unet_state_from_jax(params))
        cast_compute_dtype(pm, torch.bfloat16)
        with torch.no_grad():
            got[fast] = pm(_bcl(x), _t(t))
    np.testing.assert_allclose(got[False].numpy().transpose(0, 2, 1), want, rtol=0,
                               atol=BF16_UNET_ATOL)
    assert not torch.equal(got[False], got[True])


def test_config_switches_reach_the_models():
    """fast_sampling_math reaches the sampler's UNet, fast_train_math the
    stage-2 trainer's."""
    from sleepgen_torch.sample.sample_ldm import build_models

    cfg = Config()
    cfg.dtype = "float32"
    cfg.unet.model_channels, cfg.unet.norm_num_groups = 32, 8
    cfg.unet.channel_mult, cfg.unet.attention_resolutions = [1, 2], [2]
    cfg.aekl.num_channels = list(AEKL_CH)
    cfg.aekl.attention_levels = [False, False, True]
    for fast in (False, True):
        cfg.fast_sampling_math, cfg.fast_train_math = fast, not fast
        with torch.device("meta"):
            unet = UNet1d(num_groups=8, **UNET_KW)
            ae = AutoencoderKL(num_channels=AEKL_CH, attention_levels=(False, False, True))
        su, sa = build_models(cfg, weights.seeded_state_dict(unet, 0),
                              weights.seeded_state_dict(ae, 0), torch.device("cpu"))
        tu = T.build_trainer(cfg, weights.seeded_state_dict(ae, 0), cfg, "cpu")[0]
        flags = [m.mixed_precision for m in su.modules() if isinstance(m, SelfAttention1d)]
        assert flags and all(f == fast for f in flags)
        flags = [m.mixed_precision for m in tu.modules() if isinstance(m, SelfAttention1d)]
        assert flags and all(f == (not fast) for f in flags)
    assert Config.from_dict({"fast_sampling_math": False}).fast_sampling_math is False
