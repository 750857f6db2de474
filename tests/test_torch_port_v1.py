"""The port's first-generation pieces against the JAX package, on the CPU
in fp32, at tiny widths.

DDPMTables against JAX's for the "linear" (sqrt-space) and "cosine"
schedules and the x0 parameterisation, at rtol 1e-6; ``q_sample``,
``q_posterior``, ``p_losses``, ``p_sample`` and ``p_sample_loop`` at the
model bound of tests/test_torch_import.py (rtol 2e-3 / atol 2e-4), the
loops over a tiny UNet (model_channels 16, channel_mult (1, 2), attention
at ds 2, G 4, three channels, latent 64) on JAX's own threefry draws fed
in the JAX loop's split order. AutoencoderKLV1 (n_channels 8, ch_mult
(1, 2), one resblock per level, G 4, L 256), with and without per-
resolution attention, on JAX's eps; VAEDownsample both ways; the v1
PatchGAN (ndf 8, 3 layers) with its BatchNorm statistics; the reference
names' round trip through ``import_aekl_v1``. Every weight leaf of the
JAX modules is drawn from numpy and carried into the port with
``sleepgen_torch.utils.weights``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.diffusion import ddpm_v1 as jax_v1
from sleepgen.nn.aekl_v1 import AutoencoderKLV1 as JaxAEKLV1
from sleepgen.nn.aekl_v1 import VAEDownsample as JaxVAEDownsample
from sleepgen.nn.discriminator import DiscriminatorV1 as JaxDiscV1
from sleepgen.nn.unet1d import UNet1d as JaxUNet
from sleepgen.utils import jit_init
from sleepgen.utils.torch_import import import_aekl_v1
from sleepgen_torch.diffusion import ddpm_v1
from sleepgen_torch.nn.aekl_v1 import AutoencoderKLV1, VAEDownsample
from sleepgen_torch.nn.discriminator import DiscriminatorV1
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.utils import weights

from test_torch_port_parity import _randomize

RTOL, ATOL = 2e-3, 2e-4
TABLE_RTOL = 1e-6
B, L, LATENT, C = 2, 256, 64, 3
UNET_KW = dict(in_channels=C, out_channels=C, model_channels=16, channel_mult=(1, 2),
               attention_resolutions=(2,), num_groups=4)
AE_KW = dict(embed_dim=C, n_channels=8, z_channels=C, ch_mult=(1, 2), num_res_blocks=1,
             resolution=L, num_groups=4)
TABLE_FIELDS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                "posterior_log_variance_clipped", "posterior_mean_coef1",
                "posterior_mean_coef2", "lvlb_weights", "logvar")


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


def _blc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 1)


@pytest.fixture(scope="module")
def unet():
    """(JAX apply, port UNet) of one tiny UNet with numpy-drawn weights."""
    m = JaxUNet(**UNET_KW)
    params = _randomize(jit_init(m, jax.random.PRNGKey(0), jnp.zeros((2, LATENT, C)),
                                 jnp.zeros((2,), jnp.int32))["params"], 80)
    port = weights.load_numpy_state(UNet1d(**UNET_KW).eval(),
                                    weights.unet_state_from_jax(params))
    return (lambda x, t: m.apply({"params": params}, x, t)), port


@pytest.fixture(scope="module")
def aekl():
    """{attn_resolutions: (JAX module, params, port module)}."""
    out = {}
    for attn in ((), (L // 2,)):
        m = JaxAEKLV1(attn_resolutions=attn, **AE_KW)
        rng = jax.random.PRNGKey(1)
        params = _randomize(jit_init(m, {"params": rng}, jnp.zeros((1, L, 1)), rng)["params"],
                            81 + len(attn))
        port = weights.load_numpy_state(AutoencoderKLV1(attn_resolutions=attn, **AE_KW),
                                        weights.aekl_v1_state_from_jax(params))
        out[attn] = m, params, port.eval()
    return out


@pytest.mark.parametrize("schedule,param", [("linear", "eps"), ("cosine", "eps"),
                                            ("linear", "x0")])
def test_tables_match_jax(schedule, param):
    kw = dict(timesteps=1000, linear_start=0.0015, linear_end=0.0195,
              parameterization=param, logvar_init=0.5)
    want = jax_v1.DDPMTables.create(schedule, **kw)
    got = ddpm_v1.DDPMTables.create(schedule, **kw)
    assert got.num_timesteps == want.num_timesteps == 1000
    for name in TABLE_FIELDS:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=TABLE_RTOL, err_msg=name)


def test_linear_is_the_sqrt_space_schedule():
    """The v1 tables' "linear" is the reference's sqrt-space schedule, not
    the plain linspace that ``make_betas("linear")`` gives."""
    got = ddpm_v1.DDPMTables.create("linear", 1000, 0.0015, 0.0195).betas.double().numpy()
    np.testing.assert_allclose(got, np.linspace(0.0015**0.5, 0.0195**0.5, 1000) ** 2,
                               rtol=1e-6)


def _small_tables(steps=100):
    return (jax_v1.DDPMTables.create("linear", steps, 0.0015, 0.0195),
            ddpm_v1.DDPMTables.create("linear", steps, 0.0015, 0.0195))


def test_q_sample_and_posterior_match_jax():
    jt, pt = _small_tables()
    rng = np.random.default_rng(0)
    x0, noise = rng.normal(size=(2, B, LATENT, C)).astype(np.float32)
    t = np.array([3, 97])
    x_t = jax_v1.q_sample(jt, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = ddpm_v1.q_sample(pt, _bcl(x0), _t(t), _bcl(noise))
    np.testing.assert_allclose(_blc(got), np.asarray(x_t), rtol=RTOL, atol=ATOL)
    want = jax_v1.q_posterior(jt, jnp.asarray(x0), x_t, jnp.asarray(t))
    mine = ddpm_v1.q_posterior(pt, _bcl(x0), got, _t(t))
    np.testing.assert_allclose(_blc(mine[0]), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    for g, w in zip(mine[1:], want[1:]):
        np.testing.assert_allclose(g.numpy().reshape(-1), np.asarray(w).reshape(-1),
                                   rtol=TABLE_RTOL)


@pytest.mark.parametrize("loss_type,elbo", [("l2", 0.0), ("l2", 0.5), ("l1", 0.5)])
def test_p_losses_match_jax(unet, loss_type, elbo):
    jfn, port = unet
    jt, pt = _small_tables(1000)
    rng = np.random.default_rng(1)
    x0, noise = rng.normal(size=(2, B, LATENT, C)).astype(np.float32)
    t = np.array([0, 640])
    kw = dict(loss_type=loss_type, original_elbo_weight=elbo)
    loss, aux = jax_v1.p_losses(jt, jfn, jnp.asarray(x0), jnp.asarray(t),
                                jnp.asarray(noise), **kw)
    with torch.no_grad():
        mine, mine_aux = ddpm_v1.p_losses(pt, port, _bcl(x0), _t(t), _bcl(noise), **kw)
    np.testing.assert_allclose(float(mine), float(loss), rtol=RTOL, atol=ATOL)
    for k in ("loss_simple", "loss_vlb", "loss"):
        np.testing.assert_allclose(float(mine_aux[k]), float(aux[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("clip", [True, False])
def test_p_sample_matches_jax(unet, clip):
    jfn, port = unet
    jt, pt = _small_tables(1000)
    rng = np.random.default_rng(2)
    x, noise = rng.normal(size=(2, B, LATENT, C)).astype(np.float32)
    t = np.array([0, 512])
    want = jax_v1.p_sample(jt, jfn, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise),
                           clip_denoised=clip, temperature=0.7)
    with torch.no_grad():
        got = ddpm_v1.p_sample(pt, port, _bcl(x), _t(t), _bcl(noise), clip_denoised=clip,
                               temperature=0.7)
    np.testing.assert_allclose(_blc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _jax_loop_draws(rng, shape, steps):
    """The JAX loop's draws in order of use: x_T from the key split off
    first, then one per step from ``key, sub = split(key)``; in (B, C, L)."""
    rng, init_key = jax.random.split(rng)
    draws = [jax.random.normal(init_key, shape, jnp.float32)]
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        draws.append(jax.random.normal(sub, shape, jnp.float32))
    return [_bcl(d) for d in draws]


@pytest.mark.parametrize("steps", [4, 8])
def test_p_sample_loop_matches_jax(unet, steps):
    jfn, port = unet
    jt, pt = _small_tables(steps)
    rng = jax.random.PRNGKey(steps)
    shape = (B, LATENT, C)
    want = jax_v1.p_sample_loop(jt, jfn, shape, rng)
    with torch.no_grad():
        got = ddpm_v1.p_sample_loop(pt, port, (B, C, LATENT),
                                    iter(_jax_loop_draws(rng, shape, steps)))
    assert float(np.abs(np.asarray(want)).mean()) > 0.05
    np.testing.assert_allclose(_blc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attn", [(), (L // 2,)], ids=["no_attn", "attn"])
def test_aekl_v1_matches_jax(aekl, attn):
    m, params, port = aekl[attn]
    v = {"params": params}
    x = np.random.default_rng(3).uniform(size=(B, L, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    eps = jax.random.normal(key, (B, L // 2, C), jnp.float32)
    rec_j, mu_j, sigma_j = m.apply(v, x, key)
    z_j = m.apply(v, x, key, method=JaxAEKLV1.get_ldm_inputs)
    dec_j = m.apply(v, np.asarray(mu_j), method=JaxAEKLV1.reconstruct_ldm_outputs)
    with torch.no_grad():
        rec, mu, sigma = port(_bcl(x), _bcl(eps))
        z = port.get_ldm_inputs(_bcl(x), _bcl(eps))
        dec = port.reconstruct_ldm_outputs(_bcl(mu_j))
    for name, got, want in (("recon", rec, rec_j), ("z_mu", mu, mu_j),
                            ("z_sigma", sigma, sigma_j), ("z", z, z_j), ("decode", dec, dec_j)):
        np.testing.assert_allclose(_blc(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert rec.shape == (B, 1, L) and mu.shape == (B, C, L // 2)
    assert float(np.abs(np.asarray(rec_j)).mean()) > 0.1


def test_aekl_v1_sampling_draws_from_a_generator(aekl):
    _, _, port = aekl[()]
    mu, sigma = torch.randn(B, C, 8), torch.rand(B, C, 8)
    got = port.sampling(mu, sigma, torch.Generator().manual_seed(4))
    eps = torch.randn(sigma.shape, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(got, mu + eps * sigma, rtol=0, atol=0)


def test_vae_downsample_matches_jax():
    """Max-pool by 4 down; linear interpolation by 4 up, edges included
    (``jax.image.resize`` against ``F.interpolate(align_corners=False)``)."""
    x = np.random.default_rng(4).normal(size=(B, 3072, 2)).astype(np.float32)
    jm, port = JaxVAEDownsample(), VAEDownsample()
    z_j = jm.apply({}, jnp.asarray(x), method=JaxVAEDownsample.get_ldm_inputs)
    z = port.get_ldm_inputs(_bcl(x))
    np.testing.assert_array_equal(_blc(z), np.asarray(z_j))
    np.testing.assert_array_equal(_blc(port(_bcl(x))), np.asarray(z_j))
    up_j = np.asarray(jm.apply({}, z_j, method=JaxVAEDownsample.reconstruct_ldm_outputs))
    up = _blc(port.reconstruct_ldm_outputs(z))
    assert up.shape == (B, 3072, 2)
    np.testing.assert_allclose(up, up_j, rtol=1e-6, atol=1e-6)
    for edge in (slice(0, 4), slice(-4, None)):  # the held edge samples
        np.testing.assert_allclose(up[:, edge], up_j[:, edge], rtol=1e-6, atol=1e-6)


def test_discriminator_v1_matches_jax():
    """Logits in training mode (batch statistics) with the running
    statistics moved once, then in eval mode on the moved statistics."""
    jm = JaxDiscV1(ndf=8, n_layers=3)
    x = np.random.default_rng(5).normal(size=(3, L, 1)).astype(np.float32)
    variables = jit_init(jm, {"params": jax.random.PRNGKey(2)}, jnp.asarray(x), train=True)
    params = _randomize(variables["params"], 85)
    rng = np.random.default_rng(86)
    stats = {k: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
                 "var": (1.0 + 0.2 * rng.random(s["var"].shape)).astype(np.float32)}
             for k, s in jax.device_get(variables["batch_stats"]).items()}
    want, mut = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                         mutable=["batch_stats"])
    port = weights.load_numpy_state(
        DiscriminatorV1(ndf=8, n_layers=3),
        weights.discriminator_v1_state_from_jax({"params": params, "batch_stats": stats}))
    with torch.no_grad():
        got = port(_bcl(x), update_stats=True)
    assert got.shape == (3, 1, L // 8 - 2)  # three stride-2 convs, two stride-1 k4 convs
    np.testing.assert_allclose(_blc(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    moved = weights.discriminator_v1_state_from_jax(
        {"params": params, "batch_stats": jax.device_get(mut["batch_stats"])})
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), moved[k], rtol=1e-5, atol=1e-6, err_msg=k)
    want_eval = jm.apply({"params": params, "batch_stats": mut["batch_stats"]}, x,
                         train=False)
    with torch.no_grad():
        got_eval = port.eval()(_bcl(x))
    np.testing.assert_allclose(_blc(got_eval), np.asarray(want_eval), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attn", [(), (L // 2,)], ids=["no_attn", "attn"])
def test_import_aekl_v1_reads_the_port_state_back(aekl, attn):
    """The port's AutoencoderKLV1 carries the reference's names:
    ``import_aekl_v1`` of its state dict is the JAX tree it was made from,
    exactly, and the bridge's own inverse gives the same tree."""
    _, params, port = aekl[attn]
    sd = port.state_dict()
    assert "encoder.blocks.0.weight" in sd and "encoder.blocks.1.conv1.weight" in sd
    back = import_aekl_v1(sd, ch_mult=AE_KW["ch_mult"], num_res_blocks=1, resolution=L,
                          attn_resolutions=attn)["params"]
    mine = weights.aekl_v1_state_to_jax(sd)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    for tree in (back, mine):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=jax.tree_util.keystr(k))
    weights.load_numpy_state(AutoencoderKLV1(attn_resolutions=attn, **AE_KW),
                             weights.aekl_v1_state_from_jax(back))
