"""The port's stage-2 training pieces against the JAX package, on the CPU.

Tiny widths, fp32: UNet1d model_channels 32, channel_mult (1, 2),
attention at ds 2, G 8, latent 64; AutoencoderKL [4, 4, 8], latent 1.
Every weight leaf of the JAX modules is drawn from numpy and carried into
the port with ``sleepgen_torch.utils.weights``. The random draws (t, the
latent noise, the encoder's eps) are made with numpy or JAX and handed to
both packages, since torch cannot reproduce JAX's threefry draws. Bounds:
the model bound of tests/test_torch_import.py (rtol 2e-3 / atol 2e-4) for
a loss and gradients through the whole UNet, rtol 1e-6 for Adam's update
on the same gradients, 1e-5 / 1e-6 for the DDPM step's fp32 arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sleepgen.diffusion import NoiseSchedule as JaxSchedule
from sleepgen.diffusion.schedules import ddpm_step as jax_ddpm_step
from sleepgen.nn import AutoencoderKL as JaxAEKL
from sleepgen.nn import UNet1d as JaxUNet
from sleepgen.utils import jit_init
from sleepgen_torch.diffusion import schedules
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.train import train_ldm as T
from sleepgen_torch.utils import weights

from test_torch_port_parity import AEKL_CH, ATOL, LATENT, RTOL, UNET_KW, _randomize

B = 3


@pytest.fixture(scope="module")
def models():
    jm = JaxUNet(num_groups=8, **UNET_KW)
    uparams = _randomize(jit_init(jm, jax.random.PRNGKey(0), jnp.zeros((2, LATENT, 1)),
                                  jnp.zeros((2,), jnp.int32))["params"], 30)
    ja = JaxAEKL(num_channels=AEKL_CH, latent_channels=1)
    rng = jax.random.PRNGKey(1)
    aparams = _randomize(jit_init(ja, {"params": rng}, jnp.zeros((1, 4 * LATENT, 1)), rng)
                         ["params"], 31)
    return jm, uparams, ja, aparams


def _port(uparams, aparams):
    unet = weights.load_numpy_state(UNet1d(num_groups=8, **UNET_KW),
                                    weights.unet_state_from_jax(uparams))
    ae = weights.load_numpy_state(AutoencoderKL(num_channels=AEKL_CH, latent_channels=1),
                                  weights.aekl_state_from_jax(aparams)).requires_grad_(False)
    return unet, ae


def _t(a):
    return torch.from_numpy(np.array(a))


def _bcl(a):
    return _t(np.asarray(a).transpose(0, 2, 1))


def _inputs(seed=40):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(B, 4 * LATENT, 1)).astype(np.float32)
    enc_eps = rng.normal(size=(B, LATENT, 1)).astype(np.float32)
    noise = rng.normal(size=(B, LATENT, 1)).astype(np.float32)
    t = np.array([3, 517, 998], np.int32)
    return x, enc_eps, noise, t


def _train_schedules():
    args = ("linear_beta", 1000, 0.0015, 0.0195)
    return (JaxSchedule.create(*args, prediction_type="epsilon"),
            schedules.NoiseSchedule.create(*args, prediction_type="epsilon"))


def test_training_step_matches_jax(models):
    """Loss and every parameter gradient of one step, against
    jax.value_and_grad of the same pieces composed in JAX (encode, z = mu +
    eps sigma, add_noise, the UNet, the MSE); then the step's Adam update
    and EMA."""
    jm, uparams, ja, aparams = models
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

    unet, ae = _port(uparams, aparams)
    opt = torch.optim.Adam(unet.parameters(), lr=1e-4)
    ema = {k: v.detach().clone() for k, v in unet.named_parameters()}
    before = {k: v.detach().clone() for k, v in unet.named_parameters()}
    step = T.make_ldm_train_step(unet, ae, ps, opt, sf, ema=ema, ema_decay=0.9)
    loss = step(_bcl(x), _t(t).long(), _bcl(noise), _bcl(enc_eps))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL, atol=ATOL)
    assert float(want_loss) > 0.1
    grads = dict(unet.named_parameters())
    assert set(grads) == set(want_grads)
    assert max(float(np.abs(g).max()) for g in want_grads.values()) > 0.1
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), g, rtol=RTOL, atol=ATOL, err_msg=k)

    opt_j = optax.adam(1e-4)
    start = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    up, _ = jax.jit(opt_j.update)(jax.tree_util.tree_map(jnp.asarray, want_grads),
                                  opt_j.init(start), start)
    for k, p in unet.named_parameters():
        new = before[k].numpy() + np.asarray(up[k])
        np.testing.assert_allclose(p.detach().numpy(), new, rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(ema[k].numpy(),
                                   0.9 * before[k].numpy() + 0.1 * p.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_adam_matches_optax():
    """torch.optim.Adam(lr=1e-4) and optax.adam(1e-4), fed the same numpy
    gradients for three steps."""
    rng = np.random.default_rng(41)
    shapes = {"w": (4, 3), "b": (5,)}
    params = {k: (1.0 + 0.1 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10.0**-i for k, s in shapes.items()}
             for i in range(3)]
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(tp.values(), lr=1e-4)
    opt_j = optax.adam(1e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt_j.init(jp)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        up, state = opt_j.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, up)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6)


def test_scale_factor_matches_jax(models):
    from sleepgen.train.train_ldm import compute_scale_factor as jax_scale_factor

    _, _, ja, aparams = models
    x = _inputs()[0]
    rng = jax.random.PRNGKey(5)
    want = float(jax_scale_factor(ja, aparams, jnp.asarray(x), rng))
    # JAX's encode_stage_2_inputs draws eps = normal(rng, z_sigma.shape): hand it over
    enc_eps = np.asarray(jax.random.normal(rng, (B, LATENT, 1), jnp.float32))
    _, ae = _port(models[1], aparams)
    got = T.compute_scale_factor(ae, _bcl(x), _bcl(enc_eps))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("t,clip", [(999, True), (500, False), (0, True)])
def test_ddpm_step_matches_jax(t, clip):
    js, ps = _train_schedules()
    rng = np.random.default_rng(42)
    out, x, noise = rng.normal(size=(3, 2, 16, 1)).astype(np.float32)
    want = jax_ddpm_step(js, jnp.asarray(out), jnp.asarray(t), jnp.asarray(x),
                         jnp.asarray(noise), clip_sample=clip)
    got = schedules.ddpm_step(ps, _t(out), t, _t(x), _t(noise), clip_sample=clip)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_ddpm_loop_draws_from_its_generator():
    """Same generator seed, same sample; the loop runs every timestep."""
    from sleepgen_torch.sample.samplers import ddpm_sample_loop

    ps = schedules.NoiseSchedule.create("linear_beta", 12, 0.0015, 0.0195)
    calls = []

    def model(x, t):
        calls.append(int(t[0]))
        return 0.1 * x

    x_T = torch.randn(2, 1, 8, generator=torch.Generator().manual_seed(0))
    a = ddpm_sample_loop(model, ps, x_T, torch.Generator().manual_seed(1), clip_sample=False)
    b = ddpm_sample_loop(model, ps, x_T, torch.Generator().manual_seed(1), clip_sample=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert calls[:12] == list(range(11, -1, -1)) and bool(torch.isfinite(a).all())


def test_unet_init_zeroes_what_jax_zeroes(models):
    """The port's initial weights are zero exactly where the JAX UNet's
    initialiser gives zeros, and GroupNorm weights are one."""
    jm = models[0]
    jax_init = weights.unet_state_from_jax(jax.device_get(jit_init(
        jm, jax.random.PRNGKey(0), jnp.zeros((2, LATENT, 1)), jnp.zeros((2,), jnp.int32))
        ["params"]))
    mine = T.init_unet_state(UNet1d(num_groups=8, **UNET_KW), seed=0)
    assert set(mine) == set(jax_init)
    for k, v in jax_init.items():
        assert (not v.any()) == (not mine[k].any()), k
        if k.endswith("weight") and v.ndim == 1:
            np.testing.assert_array_equal(mine[k], 1.0)
        if v.ndim >= 2 and v.any():
            assert abs(mine[k].std() / v.std() - 1.0) < 0.5, k


def test_unet_weights_round_trip_to_jax(models):
    """unet_state_to_jax inverts unet_state_from_jax exactly, on every key,
    and the JAX UNet applied to the tree gives the port's output."""
    jm, uparams, _, _ = models
    sd = weights.unet_state_from_jax(uparams)
    tree = weights.unet_state_to_jax({k: torch.from_numpy(v) for k, v in sd.items()})
    flat_a = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        jax.device_get(uparams))}
    flat_b = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
    back = weights.unet_state_from_jax(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)

    unet, _ = _port(uparams, models[3])
    x = np.random.default_rng(43).normal(size=(2, LATENT, 1)).astype(np.float32)
    t = np.array([5, 700], np.int32)
    want = np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = unet(_bcl(x), _t(t).long())
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, rtol=RTOL, atol=ATOL)


def test_loader_and_synthetic_data_match_jax(tmp_path):
    """Same recordings from the same seed; same windows and batches from
    the same crop generator seed, read from the same split CSV."""
    from sleepgen.data.dataset import load_split as jax_load_split
    from sleepgen.data.synthetic import synthetic_recording as jax_recording
    from sleepgen_torch.data.dataset import load_split
    from sleepgen_torch.data.synthetic import (synthetic_recording, write_ids_csv,
                                               write_synthetic_npy_tree)

    np.testing.assert_array_equal(synthetic_recording(7, 40.0), jax_recording(7, 40.0))
    rows = write_synthetic_npy_tree(tmp_path / "npy", n_subjects=3, duration_s=45.0, seed=2)
    csv_path = write_ids_csv(tmp_path / "ids.csv", rows)
    mine, ref = load_split(csv_path, tmp_path / "npy"), jax_load_split(csv_path, tmp_path / "npy")
    assert mine.names == ref.names and len(mine) == 6
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(mine.epoch_windows(r1), ref.epoch_windows(r2))
    for a, b in zip(mine.epoch_batches(4, r1, shuffle=True),
                    ref.epoch_batches(4, r2, shuffle=True), strict=True):
        np.testing.assert_array_equal(a, b)
