"""The port's models, diffusion math, sampler and CLI against the JAX
package, on the CPU in fp32, at tiny widths.

UNet1d: model_channels 32, channel_mult (1, 2), attention at ds 2, G 8,
latent 64. AutoencoderKL: [4, 4, 8], latent 1. Every weight leaf of the
JAX modules is drawn from numpy (the zero-initialised output convolutions
included, so no output is trivially zero) and carried into the port with
``sleepgen_torch.utils.weights``.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.diffusion import NoiseSchedule as JaxSchedule
from sleepgen.diffusion import ddim_step as jax_ddim_step
from sleepgen.diffusion.schedules import ddim_timesteps as jax_ddim_timesteps
from sleepgen.diffusion.schedules import make_betas as jax_make_betas
from sleepgen.nn import AutoencoderKL as JaxAEKL
from sleepgen.nn import UNet1d as JaxUNet
from sleepgen.utils import jit_init
from sleepgen_torch.config import Config
from sleepgen_torch.diffusion import schedules
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.utils import weights

CONFIG_DIR = Path(__file__).resolve().parent.parent / "sleepgen" / "configs"
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=2,
               attention_resolutions=(2,))
AEKL_CH = (4, 4, 8)
LATENT = 64
# Model parity bound of tests/test_torch_import.py (a whole UNet).
RTOL, ATOL = 2e-3, 2e-4


def _randomize(tree, seed):
    """Every leaf drawn from numpy: kernels N(0, 1/fan_in), GroupNorm
    scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        shape = leaf.shape
        if "scale" in name:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "bias" in name:
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def _jax_unet(num_classes=0):
    m = JaxUNet(num_groups=8, num_classes=num_classes, **UNET_KW)
    args = (jax.random.PRNGKey(0), jnp.zeros((2, LATENT, 1)), jnp.zeros((2,), jnp.int32))
    if num_classes:
        args += (jnp.zeros((2,), jnp.int32),)
    return m, _randomize(jit_init(m, *args)["params"], 10 + num_classes)


def _port_unet(params, num_classes=0):
    m = UNet1d(num_groups=8, num_classes=num_classes, **UNET_KW).eval()
    return weights.load_numpy_state(m, weights.unet_state_from_jax(params))


@pytest.fixture(scope="module")
def unet_pair():
    m, params = _jax_unet()
    return m, params, _port_unet(params)


@pytest.fixture(scope="module")
def aekl_pair():
    m = JaxAEKL(num_channels=AEKL_CH, latent_channels=1)
    rng = jax.random.PRNGKey(1)
    params = _randomize(jit_init(m, {"params": rng}, jnp.zeros((1, 4 * LATENT, 1)), rng)
                        ["params"], 20)
    port = AutoencoderKL(num_channels=AEKL_CH, latent_channels=1).eval()
    return m, params, weights.load_numpy_state(port, weights.aekl_state_from_jax(params))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("num_classes", [0, 3])
def test_unet_matches_jax(unet_pair, num_classes):
    if num_classes:
        jm, params = _jax_unet(num_classes)
        pm = _port_unet(params, num_classes)
    else:
        jm, params, pm = unet_pair
    x = np.random.default_rng(1).normal(size=(2, LATENT, 1)).astype(np.float32)
    t = np.array([17, 931], np.int32)
    y = np.array([2, -1], np.int32)  # -1: the guidance null label
    jargs = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(y),) if num_classes else ())
    want = np.asarray(jax.jit(jm.apply)({"params": params}, *jargs))
    with torch.no_grad():
        got = pm(_t(x.transpose(0, 2, 1)), _t(t), _t(y).long() if num_classes else None)
    assert float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, rtol=RTOL, atol=ATOL)


def test_aekl_matches_jax(aekl_pair):
    jm, params, pm = aekl_pair
    v = {"params": params}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4 * LATENT, 1)).astype(np.float32)
    z = rng.normal(size=(2, LATENT, 1)).astype(np.float32)
    mu_j, sigma_j = jax.jit(lambda a: jm.apply(v, a, method=JaxAEKL.encode))(x)
    dec_j = jax.jit(lambda a: jm.apply(v, a, method=JaxAEKL.decode))(z)
    rec_j = jax.jit(lambda a: jm.apply(v, a, method=JaxAEKL.reconstruct))(x)
    with torch.no_grad():
        mu, sigma = pm.encode(_t(x.transpose(0, 2, 1)))
        dec = pm.decode(_t(z.transpose(0, 2, 1)))
        rec = pm.reconstruct(_t(x.transpose(0, 2, 1)))
    for got, want in ((mu, mu_j), (sigma, sigma_j), (dec, dec_j), (rec, rec_j)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    assert dec.shape == (2, 1, 4 * LATENT)


def test_reference_exporters_load_strict(unet_pair, aekl_pair):
    """The port's module names are the reference UNetModel's and MONAI's:
    the JAX package's torch exporters' state dicts load with strict=True
    and equal the port's own conversion."""
    from sleepgen.utils.torch_export import export_aekl_monai, export_unet1d

    _, uparams, _ = unet_pair
    sd = export_unet1d({"params": uparams}, channel_mult=UNET_KW["channel_mult"],
                       num_res_blocks=2, attention_resolutions=UNET_KW["attention_resolutions"])
    mine = weights.unet_state_from_jax(uparams)
    assert set(sd) == set(mine)
    for k in sd:
        np.testing.assert_array_equal(sd[k], mine[k], err_msg=k)
    weights.load_numpy_state(UNet1d(num_groups=8, **UNET_KW), sd)

    _, aparams, _ = aekl_pair
    sd = export_aekl_monai({"params": aparams}, num_channels=AEKL_CH)
    mine = weights.aekl_state_from_jax(aparams)
    assert set(sd) == set(mine)
    for k in sd:
        np.testing.assert_array_equal(sd[k], mine[k], err_msg=k)
    weights.load_numpy_state(AutoencoderKL(num_channels=AEKL_CH), sd)


def test_params_npz_roundtrip(tmp_path, aekl_pair):
    _, params, _ = aekl_pair
    path = weights.save_params_npz(tmp_path / "params.npz", {"params": params})
    back = weights.load_params_npz(path)
    flat_a = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(params)}
    flat_b = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(p.name for p in CONFIG_DIR.glob("*.yaml")))
def test_config_reads_the_same_yamls(name):
    from sleepgen.config import Config as JaxConfig

    mine, ref = Config.from_yaml(CONFIG_DIR / name), JaxConfig.from_yaml(CONFIG_DIR / name)
    for section in ("train", "losses", "aekl", "discriminator", "unet", "diffusion"):
        assert dataclasses.asdict(getattr(mine, section)) == dataclasses.asdict(
            getattr(ref, section)), section
    assert (mine.spectral, mine.dataset, mine.dtype) == (ref.spectral, ref.dataset, ref.dtype)


@pytest.mark.parametrize("schedule", ["linear_beta", "scaled_linear_beta", "cosine",
                                      "sigmoid_beta"])
def test_schedule_tables_match_jax(schedule):
    np.testing.assert_array_equal(schedules.make_betas(schedule, 1000, 0.0015, 0.0205),
                                  jax_make_betas(schedule, 1000, 0.0015, 0.0205))
    js = JaxSchedule.create(schedule, 1000, 0.0015, 0.0205, prediction_type="v_prediction")
    ps = schedules.NoiseSchedule.create(schedule, 1000, 0.0015, 0.0205,
                                        prediction_type="v_prediction")
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    rng = np.random.default_rng(3)
    x0, eps = rng.normal(size=(2, 2, 8, 1)).astype(np.float32)
    t = np.array([5, 800])
    for name in ("add_noise", "velocity"):
        want = getattr(js, name)(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))
        got = getattr(ps, name)(_t(x0), _t(eps), _t(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t,t_prev", [(995, 990), (500, 495), (0, -5)])
def test_ddim_step_matches_jax(t, t_prev):
    np.testing.assert_array_equal(schedules.ddim_timesteps(1000, 200),
                                  jax_ddim_timesteps(1000, 200))
    js = JaxSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                            prediction_type="v_prediction")
    ps = schedules.NoiseSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                                        prediction_type="v_prediction")
    rng = np.random.default_rng(4)
    out, x = rng.normal(size=(2, 3, 16, 1)).astype(np.float32)
    want = jax_ddim_step(js, jnp.asarray(out), t, t_prev, jnp.asarray(x))
    got = schedules.ddim_step(ps, _t(out), t, t_prev, _t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_multitaper_psd_matches_jax():
    from sleepgen.eval.psd import multitaper_psd_db as jax_psd
    from sleepgen_torch.eval.psd import multitaper_psd_db

    x = np.random.default_rng(5).normal(size=(3, 1, 3000)).astype(np.float32)
    got, freqs = multitaper_psd_db(x)
    want, want_freqs = jax_psd(x)
    np.testing.assert_allclose(freqs, want_freqs, rtol=1e-6)
    # dB of fp32 (JAX) vs float64 (port) spectra
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_seed_noise_is_per_seed():
    from sleepgen_torch.sample.samplers import seed_noise

    a = seed_noise([3, 4, 5], (16, 1), "cpu")
    b = torch.cat([seed_noise([3], (16, 1), "cpu"), seed_noise([4, 5], (16, 1), "cpu")])
    assert a.shape == (3, 16, 1) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_whole_sampler_matches_jax(unet_pair, aekl_pair):
    """4 DDIM steps from the same x_T, decode of z / scale_factor, crop:
    make_ldm_sampler against the JAX ddim_sample_loop and
    decode_stage_2_outputs composed the same way. Tolerance: the model
    bound (2e-3 / 2e-4), as fp32 differences in four UNet calls and the
    decode stay far below it."""
    from sleepgen.sample.samplers import ddim_sample_loop as jax_ddim_loop
    from sleepgen_torch.sample.sample_ldm import make_ldm_sampler
    from sleepgen_torch.sample.samplers import seed_noise

    jm, uparams, pm = unet_pair
    ja, aparams, pa = aekl_pair
    seeds, steps, sf = [0, 1], 4, 1.7
    js = JaxSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                            prediction_type="v_prediction")
    ps = schedules.NoiseSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                                        prediction_type="v_prediction")
    x_T = jnp.asarray(seed_noise(seeds, (LATENT, 1), "cpu").numpy())

    @jax.jit
    def jax_sample(x):
        z = jax_ddim_loop(lambda a, t: jm.apply({"params": uparams}, a, t), js, x, steps)
        sig = ja.apply({"params": aparams}, z / sf, method=JaxAEKL.decode_stage_2_outputs)
        return sig[:, 36:-36, :]

    want = np.asarray(jax_sample(x_T))
    got = make_ldm_sampler(pm, pa, ps, latent_len=LATENT, num_inference_steps=steps,
                           device="cpu")(sf, seeds)
    assert got.shape == want.shape == (2, 4 * LATENT - 72, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _write_run_dirs(tmp_path, unet_params, ae_params):
    ae_dir, ldm_dir = tmp_path / "aekl", tmp_path / "ldm"
    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = list(AEKL_CH)
    cfg.unet.model_channels = UNET_KW["model_channels"]
    cfg.unet.channel_mult = list(UNET_KW["channel_mult"])
    cfg.unet.attention_resolutions = list(UNET_KW["attention_resolutions"])
    cfg.unet.norm_num_groups = 8
    cfg.unet.image_size = LATENT
    for d, params in ((ae_dir, ae_params), (ldm_dir, unet_params)):
        d.mkdir()
        cfg.to_yaml(d / "config.yaml")
        weights.save_params_npz(d / "params.npz", {"params": params})
    (ldm_dir / "scale_factor.txt").write_text("1.25")
    return ae_dir, ldm_dir


def test_cli_writes_artifact_contract(tmp_path, unet_pair, aekl_pair):
    from sleepgen_torch.cli.sample_trials import main

    ae_dir, ldm_dir = _write_run_dirs(tmp_path, unet_pair[1], aekl_pair[1])
    common = ["--output_dir", str(tmp_path / "out"), "--best_model_path", str(ae_dir),
              "--diffusion_path", str(ldm_dir), "--start_seed", "3", "--stop_seed", "6",
              "--num_inference_steps", "2", "--batch_size", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(common)  # the default device is the GPU
    main(common + ["--device", "cpu"])
    out = tmp_path / "out" / "samples_ldm_1_no-spectral_edfx"
    for seed in (3, 4, 5):
        sample = np.load(out / f"sample_{seed}.npy")
        assert sample.shape == (1, 1, 4 * LATENT - 72) and np.isfinite(sample).all()
        psds, freqs, mean = np.load(out / f"psd_list_{seed}.npy", allow_pickle=True)
        assert psds.shape == (1, len(freqs)) and freqs.max() <= 18.0
        np.testing.assert_allclose(mean, psds.mean(axis=0))
    # psd_list.npy holds the last batch's entries (one seed), as in the JAX package
    assert len(np.load(out / "psd_list.npy", allow_pickle=True)) == 1
