"""The port's evaluation path against the JAX package, on the CPU in fp32:
DPM-Solver++(2M) and its timesteps, the Welch PSD, SSIM and MS-SSIM, the
band filters, USleep and its weight bridge, the Fréchet distance and the
FID over USleep's features. Same numpy inputs on both sides; each tolerance is stated where
it is used.

UNet for the DPM sampler: test_torch_port_parity's tiny one (model_channels
32, channel_mult (1, 2), attention at ds 2, G 8, latent 64), every weight
drawn from numpy. USleep: depth 4 at L 256 and the FID extractor's depth
12 at L 3000, its random parameters and random BatchNorm running
statistics (so BatchNorm is not the identity) carried over with
``usleep_state_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.diffusion import NoiseSchedule as JaxSchedule
from sleepgen.diffusion import dpm_solver as jax_dpm
from sleepgen.eval import bands as jax_bands
from sleepgen.eval import fid as jax_fid
from sleepgen.eval import msssim as jax_msssim
from sleepgen.eval import psd as jax_psd
from sleepgen.nn.usleep import USleep as JaxUSleep
from sleepgen.utils import jit_init
from sleepgen.utils.torch_import import import_usleep
from sleepgen_torch.config import Config
from sleepgen_torch.diffusion import dpm_solver
from sleepgen_torch.eval import bands, fid, msssim, psd
from sleepgen_torch.nn.usleep import USleep
from sleepgen_torch.sample.sample_ldm import sampling_schedule
from sleepgen_torch.sample.samplers import seed_noise
from sleepgen_torch.utils import weights

from test_torch_port_parity import LATENT, _t, unet_pair  # noqa: F401

# Model parity bound of tests/test_torch_import.py (a whole UNet).
RTOL, ATOL = 2e-3, 2e-4


def _schedules():
    d = Config().diffusion
    args = (d.sample_schedule, d.timesteps, d.sample_beta_start, d.sample_beta_end)
    return (JaxSchedule.create(*args, prediction_type=d.sample_prediction_type),
            sampling_schedule(Config()))


@pytest.mark.parametrize("steps", [10, 20, 25, 50])
def test_dpm_timesteps_equal_jax(steps):
    js, ps = _schedules()
    got, want = dpm_solver.dpm_timesteps(ps, steps), jax_dpm.dpm_timesteps(js, steps)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_dpm_timesteps_refuse_too_many_steps():
    _, ps = _schedules()
    with pytest.raises(ValueError, match="too many"):
        dpm_solver.dpm_timesteps(ps, 1001)


@pytest.mark.parametrize("steps", [4, 8])
def test_dpm_loop_matches_jax(unet_pair, steps):
    """The same x_T through the tiny UNet on both sides; ``steps`` model
    calls each. Tolerance: the model bound (rtol 2e-3 / atol 2e-4)."""
    jm, params, pm = unet_pair
    js, ps = _schedules()
    x_T = seed_noise([0, 1], (LATENT, 1), "cpu").numpy()  # (B, L, 1)

    want = np.asarray(jax.jit(lambda x: jax_dpm.dpm_solver_pp_2m_sample_loop(
        lambda a, t: jm.apply({"params": params}, a, t), js, x, steps))(x_T))
    calls = []

    def model_fn(x, t):
        calls.append(int(t[0]))
        with torch.no_grad():
            return pm(x, t)

    got = dpm_solver.dpm_solver_pp_2m_sample_loop(model_fn, ps, _t(x_T.transpose(0, 2, 1)),
                                                  steps)
    assert calls == dpm_solver.dpm_timesteps(ps, steps).tolist()
    assert got.dtype == torch.float32 and float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, rtol=RTOL, atol=ATOL)


def test_sampler_names_its_loops():
    from sleepgen_torch.sample.sample_ldm import SAMPLERS, make_ldm_sampler

    assert SAMPLERS["dpm++2m"] is dpm_solver.dpm_solver_pp_2m_sample_loop
    with pytest.raises(ValueError, match="unknown sampler"):
        make_ldm_sampler(None, None, _schedules()[1], sampler="euler", device="cpu")


@pytest.mark.parametrize("nperseg,noverlap,fmax", [(256, 128, 18.0), (255, 100, None)])
def test_welch_psd_matches_jax(nperseg, noverlap, fmax):
    """Float64 (port) against fp32 (JAX) spectra: rtol 1e-4 / atol 1e-9 on
    V^2/Hz of unit-variance input; the dB helpers to 1e-3 dB, as the
    multitaper's parity test holds them."""
    x = np.random.default_rng(7).normal(size=(3, 1, 3000)).astype(np.float32)
    got, freqs = psd.welch_psd(x, nperseg=nperseg, noverlap=noverlap, fmax=fmax)
    want, want_freqs = jax_psd.welch_psd(jnp.asarray(x), nperseg=nperseg, noverlap=noverlap,
                                         fmax=fmax)
    np.testing.assert_allclose(freqs, np.asarray(want_freqs), rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-9)
    if fmax is not None:
        got_db, got_f = psd.welch_psd_db(x)
        want_db, want_f = jax_psd.welch_psd_db(x)
        assert got_db.dtype == np.float32 and got_f.max() <= 18.0
        np.testing.assert_allclose(got_db, want_db, atol=1e-3)


def _pair(shape_blc, seed):
    """x uniform in [0, 1] and a noisy copy, (B, L, C)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape_blc).astype(np.float32)
    return x, np.clip(x + 0.2 * rng.normal(size=shape_blc), 0, 1).astype(np.float32)


@pytest.mark.parametrize("kernel_type,kernel_size", [("gaussian", 7), ("uniform", 16)])
def test_ssim_and_ms_ssim_match_jax(kernel_type, kernel_size):
    """Fp32 on both sides; rtol 1e-5 / atol 1e-6 (sums of at most 16
    products per window, then means over the window)."""
    x, y = _pair((3, 1000, 2), 8)
    kw = dict(kernel_size=kernel_size, kernel_type=kernel_type)
    xb, yb = _t(x.transpose(0, 2, 1)), _t(y.transpose(0, 2, 1))
    for name in ("ssim_1d", "ms_ssim_1d"):
        want = np.asarray(jax.jit(lambda a, b: getattr(jax_msssim, name)(a, b, **kw))(x, y))
        got = getattr(msssim, name)(xb, yb, **kw)
        assert got.shape == (3,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6, err_msg=name)
    # identical inputs score 1
    np.testing.assert_allclose(msssim.ms_ssim_1d(xb, xb, **kw).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("band", sorted(jax_bands.EEG_BANDS))
def test_filter_band_matches_jax(band):
    """401 fp32 taps over a reflect-padded signal; rtol 1e-4 / atol 1e-5
    (the output is of order 0.1, each a sum of 401 products)."""
    np.testing.assert_array_equal(bands.firwin_bandpass(*bands.EEG_BANDS[band]),
                                  jax_bands.firwin_bandpass(*jax_bands.EEG_BANDS[band]))
    x = np.random.default_rng(9).normal(size=(2, 1000, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax_bands.filter_band(a, band))(x))
    got = bands.filter_band(_t(x.transpose(0, 2, 1)), band)
    assert got.shape == (2, 2, 1000)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, rtol=1e-4, atol=1e-5)


USLEEP_CASES = {"depth4_L256": dict(depth=4, length=256, input_size_s=2.555),
                "depth12_L3000": dict(depth=12, length=3000, input_size_s=30.0)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: the suite runs several
    worker processes on the same cores, where each process's spinning
    thread pool slows every small op of the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(USLEEP_CASES))
def usleep_pair(request):
    """The JAX USleep with every parameter and running statistic drawn
    from numpy (means N(0, 0.1^2), variances U(0.5, 1.5)), and the port's
    USleep loaded from ``usleep_state_from_jax`` of the same variables."""
    case = USLEEP_CASES[request.param]
    kw = dict(depth=case["depth"], input_size_s=case["input_size_s"])
    jm = JaxUSleep(in_chans=2, **kw)
    v = jax.device_get(jit_init(jm, jax.random.PRNGKey(0),
                                jnp.zeros((1, case["length"], 2)), train=False))
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "mean" in name:
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
                ).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, {k: v[k] for k in ("params", "batch_stats")})
    pm = weights.load_numpy_state(USleep(**kw), weights.usleep_state_from_jax(v)).eval()
    return jm, v, pm, case


def test_usleep_matches_jax(usleep_pair):
    """y, decoded and bottom in fp32 at the model bound (rtol 2e-3 / atol
    2e-4), the features the FID reads among them."""
    jm, v, pm, case = usleep_pair
    x = np.random.default_rng(12).uniform(size=(3, case["length"], 2)).astype(np.float32)
    want = jax.jit(lambda a: jm.apply(v, a, train=False))(jnp.asarray(x))
    with torch.no_grad():
        got = pm(_t(x.transpose(0, 2, 1)))
        bottom, _ = pm.encode(_t(x.transpose(0, 2, 1)))
    torch.testing.assert_close(bottom, got[2], rtol=0, atol=0)
    for name, g, w in zip(("y", "decoded", "bottom"), got, want):
        w = np.asarray(w)
        g = g.numpy() if g.dim() == 2 else g.numpy().transpose(0, 2, 1)
        assert g.shape == w.shape, name
        assert float(np.abs(w).mean()) > 1e-2, name
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    if case["depth"] == 12:
        assert got[2].shape == (3, 302, 1)


def test_usleep_bridge_round_trips_through_the_reference_importer(usleep_pair):
    """import_usleep(usleep_state_from_jax(v)) returns v exactly: the
    port's names are those the JAX package imports the reference's
    braindecode state dict from."""
    _, v, pm, case = usleep_pair
    sd = weights.usleep_state_from_jax(v)
    assert set(sd) == set(pm.state_dict())
    back = import_usleep(sd, depth=case["depth"])
    flat = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(v)}
    flat_back = {jax.tree_util.keystr(p): a
                 for p, a in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat) == set(flat_back)
    for k in flat:
        np.testing.assert_array_equal(flat_back[k], flat[k], err_msg=k)


def test_usleep_fid_features_match_jax(usleep_pair):
    """Features of (N, 1, L) windows in batches (channel duplicated),
    against the JAX package's on the same (N, L, 1) windows, at the model
    bound."""
    jm, v, pm, case = usleep_pair
    x = np.random.default_rng(13).uniform(size=(5, case["length"], 1)).astype(np.float32)
    want = jax_fid.usleep_fid_features(jm, v, x, batch_size=2)
    got = fid.usleep_fid_features(pm, np.ascontiguousarray(x.transpose(0, 2, 1)),
                                  batch_size=2, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_compute_fid_matches_jax(usleep_pair):
    """FID of 6 real against 5 synthetic (N, 1, L) windows, against the
    JAX package's on the same (N, L, 1) windows: rtol 1e-3 (features at
    the model bound, then covariances of a few windows)."""
    jm, v, pm, case = usleep_pair
    rng = np.random.default_rng(15)
    real = rng.uniform(size=(6, case["length"], 1)).astype(np.float32)
    synth = rng.uniform(0.2, 0.9, size=(5, case["length"], 1)).astype(np.float32)
    want = jax_fid.compute_fid(jm, v, real, synth, batch_size=4)
    got = fid.compute_fid(pm, np.ascontiguousarray(real.transpose(0, 2, 1)),
                          np.ascontiguousarray(synth.transpose(0, 2, 1)), batch_size=4,
                          device="cpu")
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_frechet_distance_matches_jax():
    """The same float64 numpy on both sides: within 1e-10."""
    rng = np.random.default_rng(14)
    a = rng.normal(size=(200, 16))
    b = rng.normal(0.3, 1.2, size=(150, 16))
    for x, y in ((a, b), (a, a), (b[:, :4], a[:150, :4])):
        np.testing.assert_allclose(fid.frechet_distance(x, y), jax_fid.frechet_distance(x, y),
                                   rtol=0, atol=1e-10)
    assert abs(fid.frechet_distance(a, a)) < 1e-8
