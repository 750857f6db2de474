"""The port's RePaint imputation against the JAX package, on the CPU, and
its ``impute`` CLI in both modes.

Against JAX (fp32, the model bound rtol 2e-3 / atol 2e-4 of
tests/test_torch_import.py unless a test states another): the tiny DM of
tests/test_torch_port_dm.py (UNet1d model_channels 32, channel_mult
(1, 2), attention at ds 2, G 8, one channel, L 256), unconditional and
with 5 classes, and for the latent mode test_torch_port_parity's UNet on
a 64-long latent and its AEKL [4, 4, 8]. Every loop runs over an 8-entry
linear schedule. The JAX loops draw with threefry keys: the tests rebuild
those draws in the JAX loop's split order and feed them to the port's
loop as its noise. The observed region must equal ``x_known`` exactly.
The CLI runs on port run dirs with seeded weights (model channels 16,
3072 samples, an 8-entry schedule).
"""
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.sample import samplers as jax_samplers
from sleepgen_torch.config import Config
from sleepgen_torch.sample import samplers
from sleepgen_torch.sample.sample_ldm import build_aekl, build_dm, build_models, build_unet
from sleepgen_torch.train.common import make_generator
from sleepgen_torch.train.train_ldm import make_schedule
from sleepgen_torch.utils import weights

from test_torch_port_dm import (L, N_CLASSES, _bcl, _port_dm, _t, _train_schedules,  # noqa: F401
                                cond_dm, dm)
from test_torch_port_parity import LATENT, aekl_pair, unet_pair  # noqa: F401

RTOL, ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: its models are tiny,
    and the suite runs several worker processes on the same cores, where
    each process's spinning thread pool slows every small op of the
    others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STEPS = 8
B = 2


def _jax_inpaint_noises(rng, shape, steps, num_resample):
    """The JAX inpaint loop's draws in its order of use: x_T from k_init,
    then per step and pass ``key, k_f, k_r, k_j = split(key, 4)``: the
    forward noise, the reverse noise, and the jump's on all passes but the
    last. Returned in the port's (B, C, L) layout."""
    k_init, key = jax.random.split(rng)
    out = [jax.random.normal(k_init, shape, jnp.float32)]
    for _ in range(steps):
        for u in range(num_resample):
            key, k_f, k_r, k_j = jax.random.split(key, 4)
            out += [jax.random.normal(k_f, shape, jnp.float32),
                    jax.random.normal(k_r, shape, jnp.float32)]
            if u < num_resample - 1:
                out.append(jax.random.normal(k_j, shape, jnp.float32))
    return [_bcl(n) for n in out]


def _known_and_mask(length, start, stop, seed=70):
    x = np.random.default_rng(seed).uniform(0.0, 1.0, size=(B, length, 1)).astype(np.float32)
    mask = np.ones((1, length, 1), np.float32)
    mask[:, start:stop] = 0.0
    return x, mask


def _hold(got, want, x_known, mask):
    """got (B, C, L) against JAX's (B, L, C) at the model bound; the
    observed region bitwise equal to x_known."""
    want = np.asarray(want).transpose(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    obs = np.broadcast_to(mask.transpose(0, 2, 1), got.shape) == 1.0
    np.testing.assert_array_equal(got.numpy()[obs], np.broadcast_to(
        x_known.transpose(0, 2, 1), got.shape)[obs])
    assert np.abs(got.numpy()[~obs] - np.broadcast_to(
        x_known.transpose(0, 2, 1), got.shape)[~obs]).max() > 1e-2


@pytest.mark.parametrize("num_resample", [1, 2])
def test_inpaint_loop_matches_jax(dm, num_resample):
    jm, params = dm
    js, ps = _train_schedules(STEPS)
    x, mask = _known_and_mask(L, 60, 150)
    rng = jax.random.PRNGKey(3)
    want = jax_samplers.ddpm_inpaint_loop(
        lambda a, t: jm.apply({"params": params}, a, t), js, jnp.asarray(x), jnp.asarray(mask),
        rng, num_resample=num_resample)
    noises = _jax_inpaint_noises(rng, x.shape, STEPS, num_resample)
    it = iter(noises)
    with torch.no_grad():
        got = samplers.ddpm_inpaint_loop(_port_dm(params).eval(), ps, _bcl(x), _bcl(mask), it,
                                         num_resample=num_resample)
    assert next(it, None) is None  # every draw used, none short
    _hold(got, want, x, mask)


def test_inpaint_loop_draws_from_a_generator_in_its_documented_order():
    """A generator gives the same result as the iterator of its draws in the
    documented order: x_T, then per step and pass the forward, the reverse
    and (on a jump) the jump noise."""
    ps = schedules_linear(6)
    x = torch.rand(2, 1, 16, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(1, 1, 16)
    mask[..., 4:9] = 0.0
    model = lambda a, t: 0.3 * a  # noqa: E731
    got = samplers.ddpm_inpaint_loop(model, ps, x, mask, torch.Generator().manual_seed(1),
                                     num_resample=3)
    gen = torch.Generator().manual_seed(1)
    n = 1 + 6 * (3 * 2 + 2)
    draws = [torch.randn(x.shape, generator=gen) for _ in range(n)]
    want = samplers.ddpm_inpaint_loop(model, ps, x, mask, iter(draws), num_resample=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got[..., :4], x[..., :4], rtol=0, atol=0)


def schedules_linear(n):
    from sleepgen_torch.diffusion.schedules import NoiseSchedule

    return NoiseSchedule.create("linear_beta", n, 0.0015, 0.0195)


def _random_masks(rng, n, length):
    """Masks of random spans, the window's edges and the all-observed and
    all-masked cases included, (n, length, 1)."""
    masks = np.ones((n, length, 1), np.float32)
    for i in range(n - 2):
        a = int(rng.integers(0, length))
        b = int(rng.integers(a, length + 1))
        masks[i, a:b] = 0.0
        if i % 3 == 0:  # a second span
            c = int(rng.integers(0, length))
            masks[i, c:c + int(rng.integers(1, 40))] = 0.0
    masks[-1] = 0.0
    masks[0, :17] = 0.0  # touches the left edge
    masks[1, -23:] = 0.0  # touches the right edge
    return masks


@pytest.mark.parametrize("erode", [0, 1, 2, 3, 4])
def test_latent_observed_mask_matches_jax_exactly(erode):
    rng = np.random.default_rng(71 + erode)
    masks = _random_masks(rng, 12, L)
    want = np.asarray(jax_samplers.latent_observed_mask(jnp.asarray(masks), L // 4, erode))
    got = samplers.latent_observed_mask(_bcl(masks), L // 4, erode)
    assert got.shape == (12, 1, L // 4)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 2, 1))
    assert want[0, 0, 0] == 0.0 and want[-1].max() == 0.0
    if erode:  # the window's ends count as observed: not eroded
        assert got[2:-1, 0, 0].max() == 1.0


@pytest.mark.parametrize("mode", ["plain", "guided"])
def test_impute_dm_matches_jax(dm, cond_dm, mode):
    """Plain at num_resample 1; stage-conditional with classifier-free
    guidance (one 2B forward) at num_resample 2."""
    guided = mode == "guided"
    jm, params = cond_dm if guided else dm
    js, ps = _train_schedules(STEPS)
    x, mask = _known_and_mask(L, 0, 90, 72)
    labels = np.array([3, 1], np.int32) if guided else None
    nr, scale = (2, 2.0) if guided else (1, 1.0)
    key = jax.random.PRNGKey(4)
    want = jax_samplers.impute_dm(jm, params, js, jnp.asarray(x), jnp.asarray(mask), key,
                                  labels=None if labels is None else jnp.asarray(labels),
                                  num_resample=nr, guidance_scale=scale)
    unet = _port_dm(params, N_CLASSES if guided else 0).eval()
    with torch.no_grad():
        got = samplers.impute_dm(unet, ps, _bcl(x), _bcl(mask),
                                 iter(_jax_inpaint_noises(key, x.shape, STEPS, nr)),
                                 None if labels is None else _t(labels).long(), nr, scale)
    _hold(got, want, x, mask)


@pytest.mark.parametrize("num_resample", [1, 2])
def test_impute_ldm_matches_jax(unet_pair, aekl_pair, num_resample):
    """Encode with the posterior mean times the scale factor, RePaint on the
    latents without clipping under ``latent_observed_mask`` (erode 2),
    decode, splice in signal space."""
    jm, uparams, unet = unet_pair
    ja, aparams, ae = aekl_pair
    js, ps = _train_schedules(STEPS)
    x, mask = _known_and_mask(4 * LATENT, 100, 160, 73)
    key, sf = jax.random.PRNGKey(5), 1.3
    want = jax_samplers.impute_ldm(jm, ja, uparams, aparams, jnp.float32(sf), js,
                                   jnp.asarray(x), jnp.asarray(mask), key,
                                   num_resample=num_resample, latent_erode=2)
    noises = _jax_inpaint_noises(key, (B, LATENT, 1), STEPS, num_resample)
    with torch.no_grad():
        got = samplers.impute_ldm(unet, ae, sf, ps, _bcl(x), _bcl(mask), iter(noises),
                                  num_resample=num_resample, latent_erode=2)
    _hold(got, want, x, mask)


# -- the impute CLI -----------------------------------------------------------

def _cli_config(num_classes=0, image_size=3072):
    cfg = Config()
    cfg.dtype = "float32"
    cfg.unet.model_channels, cfg.unet.channel_mult = 16, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.unet.image_size, cfg.unet.num_classes = image_size, num_classes
    cfg.aekl.num_channels = [2, 2, 4]
    cfg.diffusion.timesteps = STEPS
    return cfg


def _write(path, cfg, tree, scale_factor=None):
    path.mkdir(parents=True)
    cfg.to_yaml(path / "config.yaml")
    weights.save_params_npz(path / "params.npz", {"params": tree})
    if scale_factor is not None:
        (path / "scale_factor.txt").write_text(repr(scale_factor))


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """A train-dm run dir (final_model/), a conditional one, an AEKL run dir
    and a train-ldm run dir (best_model/ with its scale factor), with
    seeded weights; and 3 windows of 3000 samples."""
    root = tmp_path_factory.mktemp("impute")
    for name, classes in (("dm", 0), ("cond_dm", N_CLASSES)):
        cfg = _cli_config(classes)
        with torch.device("meta"):
            unet = build_unet(cfg, 1, 1)
        cfg.to_yaml(root / f"{name}.yaml")
        _write(root / name / "final_model", cfg,
               weights.unet_state_to_jax(weights.seeded_state_dict(unet, 5 + classes)))
    cfg = _cli_config(image_size=768)
    with torch.device("meta"):
        ae, unet = build_aekl(cfg), build_unet(cfg, 1, 1)
    _write(root / "aekl", cfg, weights.aekl_state_to_jax(weights.seeded_state_dict(ae, 6)))
    _write(root / "ldm" / "best_model", cfg,
           weights.unet_state_to_jax(weights.seeded_state_dict(unet, 7)), 1.3)
    windows = np.random.default_rng(74).uniform(0.0, 1.0, size=(3, 3000)).astype(np.float32)
    np.save(root / "windows.npy", windows)
    return root


def _impute(monkeypatch, run_dirs, out, *flags, inp="windows.npy"):
    from sleepgen_torch.__main__ import main

    monkeypatch.setattr(sys, "argv", [
        "sleepgen_torch", "impute", "--input", str(run_dirs / inp), "--output_dir", str(out),
        "--mask_start", "1200", "--mask_len", "400", "--batch_size", "2", "--seed", "9",
        "--device", "cpu", *flags])
    main()
    return np.load(out / "imputed.npy"), np.load(out / "mask.npy")


def _direct(run_dirs, repair):
    """The CLI's batches done by hand: edge pad, the mask, the last batch
    padded with its last window, the generator of (seed 9, first window)."""
    x = np.load(run_dirs / "windows.npy")
    x_pad = np.pad(x, ((0, 0), (36, 36)), mode="edge")[:, None]
    mask = np.ones((1, 1, 3072), np.float32)
    mask[..., 36 + 1200:36 + 1600] = 0.0
    outs = []
    for i in (0, 2):
        xb = x_pad[i:i + 2]
        real = len(xb)
        xb = np.concatenate([xb, np.repeat(xb[-1:], 2 - real, 0)])
        with torch.no_grad():
            out = repair(torch.from_numpy(xb), torch.from_numpy(mask),
                         make_generator(9, "cpu", i))
        outs.append(out.numpy()[:real])
    return np.concatenate(outs)[..., 36:-36]


@pytest.fixture(scope="module")
def signal_want(run_dirs):
    """``impute_dm`` batch by batch, as the signal-mode CLI should run it."""
    cfg = Config.from_yaml(run_dirs / "dm.yaml")
    unet = build_dm(cfg, weights.unet_state_from_jax(weights.load_params_npz(
        run_dirs / "dm" / "final_model" / "params.npz")), torch.device("cpu"))
    sched = make_schedule(cfg)
    return _direct(run_dirs, lambda xb, m, g: samplers.impute_dm(unet, sched, xb, m, g))


@pytest.mark.parametrize("layout", ["N_L", "N_1_L", "N_L_1"])
def test_impute_cli_signal_mode(run_dirs, signal_want, tmp_path, monkeypatch, layout):
    """final_model/ of a train-dm run dir; the three input layouts give the
    same (N, 1, 3000) windows; observed samples exact; equal to impute_dm
    called batch by batch with the documented generators."""
    x = np.load(run_dirs / "windows.npy")
    inp = {"N_L": x, "N_1_L": x[:, None], "N_L_1": x[..., None]}[layout]
    np.save(tmp_path / "in.npy", inp)
    got, mask = _impute(monkeypatch, tmp_path, tmp_path / "out", "--diffusion_path",
                        str(run_dirs / "dm"), inp="in.npy")
    assert got.shape == (3, 1, 3000) and mask.shape == (3000,) and mask.dtype == bool
    assert not mask[1200:1600].any() and mask[:1200].all() and mask[1600:].all()
    np.testing.assert_array_equal(got[:, 0, mask], x[:, mask])
    assert np.abs(got[:, 0, ~mask] - x[:, ~mask]).max() > 1e-2
    np.testing.assert_array_equal(got, signal_want)


@pytest.mark.parametrize("aekl_dir", ["port_run_dir", "train_aekl_run_dir"])
def test_impute_cli_latent_mode(run_dirs, tmp_path, monkeypatch, aekl_dir):
    """--best_model_path: the AEKL's port run dir, or a train-aekl run dir
    whose best_model/ is read; best_model/ and its scale factor from the
    train-ldm run dir; equal to impute_ldm batch by batch."""
    ae_path = run_dirs / "aekl"
    if aekl_dir == "train_aekl_run_dir":
        ae_path = tmp_path / "aekl_run"
        shutil.copytree(run_dirs / "aekl", ae_path / "best_model")
    got, mask = _impute(monkeypatch, run_dirs, tmp_path / "out", "--diffusion_path",
                        str(run_dirs / "ldm"), "--best_model_path", str(ae_path),
                        "--num_resample", "2", "--latent_erode", "3")
    x = np.load(run_dirs / "windows.npy")
    np.testing.assert_array_equal(got[:, 0, mask], x[:, mask])
    cfg = Config.from_yaml(run_dirs / "ldm" / "best_model" / "config.yaml")
    read = lambda d: weights.load_params_npz(run_dirs / d / "params.npz")  # noqa: E731
    unet, ae = build_models(cfg, weights.unet_state_from_jax(read("ldm/best_model")),
                            weights.aekl_state_from_jax(read("aekl")), torch.device("cpu"))
    sched = make_schedule(cfg)
    want = _direct(run_dirs, lambda xb, m, g: samplers.impute_ldm(
        unet, ae, 1.3, sched, xb, m, g, num_resample=2, latent_erode=3))
    np.testing.assert_array_equal(got, want)


def test_impute_cli_conditional_and_its_errors(run_dirs, tmp_path, monkeypatch):
    """A conditional checkpoint needs --stage (guided when
    --guidance_scale is not 1); a window that does not pad to the
    checkpoint's length is refused."""
    flags = ("--diffusion_path", str(run_dirs / "cond_dm"))
    with pytest.raises(SystemExit, match="pass stage=0..4"):
        _impute(monkeypatch, run_dirs, tmp_path / "a", *flags)
    plain, _ = _impute(monkeypatch, run_dirs, tmp_path / "b", *flags, "--stage", "2")
    guided, mask = _impute(monkeypatch, run_dirs, tmp_path / "c", *flags, "--stage", "2",
                           "--guidance_scale", "3.0")
    np.testing.assert_array_equal(plain[:, 0, mask], guided[:, 0, mask])
    assert np.abs(plain - guided).max() > 1e-3
    np.save(tmp_path / "short.npy", np.zeros((2, 2990), np.float32))
    with pytest.raises(SystemExit, match="pad must equal"):
        _impute(monkeypatch, tmp_path, tmp_path / "d", "--diffusion_path",
                str(run_dirs / "dm"), inp="short.npy")
