"""The port's stage-1 pieces against the JAX package, on the CPU in fp32.

Tiny widths: AutoencoderKL [4, 4, 8], latent 1, G 1; PatchDiscriminator
with 3 layers and 8 channels; windows of L 256, batch 3. The JAX modules
are built through ``jit_init`` (``sleepgen.train.train_aekl.init_state``),
every weight leaf is drawn from numpy (``_randomize``) and the BatchNorm
running statistics are set away from their initial 0 and 1, then carried
into the port with ``sleepgen_torch.utils.weights``. The encoder's eps is
drawn as the JAX step draws it and handed to the port.

Bounds: rtol 1e-5 / atol 1e-6 for a loss alone and for the BatchNorm
running statistics; the model bound of tests/test_torch_import.py
(rtol 2e-3 / atol 2e-4) for outputs, losses and gradients through the
models. A whole step is held twice against JAX's own ``make_train_step``:
with SGD at lr 1 for both optimisers, where ``p_old - p_new`` is the
gradient; then with the two Adams of the configuration, whose first
update is about lr * sign(g) and so flips wherever a gradient's sign
rounds differently: the parameters are held leaving out the entries whose
gradient (from the SGD run) is below 1e-3 of its leaf's largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sleepgen import losses as jax_losses
from sleepgen.config import Config as JaxConfig
from sleepgen.train.train_aekl import init_state as jax_init_state
from sleepgen.train.train_aekl import make_eval_step as jax_make_eval_step
from sleepgen.train.train_aekl import make_train_step as jax_make_train_step
from sleepgen_torch import losses
from sleepgen_torch.config import Config
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.discriminator import PatchDiscriminator, same_padding
from sleepgen_torch.train import train_aekl as A
from sleepgen_torch.utils import weights

from test_torch_port_parity import ATOL, RTOL, _randomize

AEKL_CH = (4, 4, 8)
DISC_CH = 8
B, L, LATENT = 3, 256, 64
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


def _configs(spectral: bool):
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.dtype, c.spectral = "float32", spectral
        c.aekl.num_channels = list(AEKL_CH)
        c.discriminator.num_channels = DISC_CH
    return jcfg, cfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: the suite runs several
    worker processes on the same cores, where each process's spinning
    thread pool slows every small op of the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """JAX state with numpy-drawn weights and BatchNorm statistics, a batch
    (B, L, 1), the step's rng and the eps the JAX step draws from it."""
    jcfg, _ = _configs(False)
    state, ae, disc, _, _ = jax_init_state(jcfg, jax.random.PRNGKey(0), window=L)
    params_g = _randomize(state.params_g, 60)
    params_d = _randomize(state.params_d, 61)
    rng = np.random.default_rng(62)
    stats = {name: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
                    "var": (1.0 + 0.2 * rng.random(s["var"].shape)).astype(np.float32)}
             for name, s in jax.device_get(state.batch_stats_d).items()}
    x = rng.uniform(0.0, 1.0, size=(B, L, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (B, LATENT, 1), jnp.float32))
    return dict(state=state, ae=ae, disc=disc, params_g=params_g, params_d=params_d,
                stats=stats, x=x, key=key, eps=eps)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bcl(a):
    return _t(np.asarray(a).transpose(0, 2, 1))


def _port_models(s):
    ae = weights.load_numpy_state(AutoencoderKL(num_channels=AEKL_CH, latent_channels=1),
                                  weights.aekl_state_from_jax(s["params_g"]))
    disc = weights.load_numpy_state(
        PatchDiscriminator(3, DISC_CH),
        weights.discriminator_state_from_jax({"params": s["params_d"], "batch_stats": s["stats"]}))
    return ae, disc


def _disc_state(params, stats):
    return weights.discriminator_state_from_jax({"params": jax.device_get(params),
                                                 "batch_stats": jax.device_get(stats)})


_RUNS = {}


def _run(s, opt: str, spectral: bool):
    """One step of each package from the same weights, batch and eps:
    (JAX metrics, JAX new G and D state dicts, port metrics, port new G and
    D state dicts), cached per (opt, spectral)."""
    if (opt, spectral) in _RUNS:
        return _RUNS[(opt, spectral)]
    jcfg, cfg = _configs(spectral)
    if opt == "sgd":
        jopt_g = jopt_d = optax.sgd(1.0)
    else:
        jopt_g = optax.adam(jcfg.losses.optimizer_g_lr)
        jopt_d = optax.adam(jcfg.losses.optimizer_d_lr)
    pg, pd = s["params_g"], s["params_d"]
    # copies: the JAX step donates its state's buffers
    state = jax.tree_util.tree_map(jnp.array, s["state"].replace(
        params_g=pg, opt_g=jopt_g.init(pg), params_d=pd, batch_stats_d=s["stats"],
        opt_d=jopt_d.init(pd)))
    new, jm = jax_make_train_step(s["ae"], s["disc"], jopt_g, jopt_d, jcfg)(
        state, jnp.asarray(s["x"]), s["key"])
    want = ({k: float(v) for k, v in jm.items()},
            weights.aekl_state_from_jax(jax.device_get(new.params_g)),
            _disc_state(new.params_d, new.batch_stats_d))

    ae, disc = _port_models(s)
    if opt == "sgd":
        opt_g = torch.optim.SGD(ae.parameters(), lr=1.0)
        opt_d = torch.optim.SGD(disc.parameters(), lr=1.0)
    else:
        opt_g = torch.optim.Adam(ae.parameters(), lr=cfg.losses.optimizer_g_lr)
        opt_d = torch.optim.Adam(disc.parameters(), lr=cfg.losses.optimizer_d_lr)
    pm = A.make_train_step(ae, disc, opt_g, opt_d, cfg)(_bcl(s["x"]), _bcl(s["eps"]))
    got = ({k: float(v) for k, v in pm.items()},
           {k: v.numpy() for k, v in ae.state_dict().items()},
           {k: v.numpy() for k, v in disc.state_dict().items()})
    _RUNS[(opt, spectral)] = want, got
    return want, got


def _old(s):
    return (weights.aekl_state_from_jax(s["params_g"]), _disc_state(s["params_d"], s["stats"]))


def _is_buffer(k):
    return k.endswith(("running_mean", "running_var"))


# -- losses --------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(70)
    mu = rng.normal(size=(4, 16, 2)).astype(np.float32)
    sigma = rng.uniform(0.2, 2.0, size=(4, 16, 2)).astype(np.float32)
    fake, real = rng.normal(size=(2, 4, 12, 1)).astype(np.float32)
    a, b = rng.normal(size=(2, 3, 40, 2)).astype(np.float32)
    return mu, sigma, fake, real, a, b


LOSS_CASES = {
    "kl_gaussian": (lambda mu, sig, f, r, a, b: jax_losses.kl_gaussian(mu, sig),
                    lambda mu, sig, f, r, a, b: losses.kl_gaussian(_bcl(mu), _bcl(sig))),
    "generator_adv": (lambda mu, sig, f, r, a, b: jax_losses.generator_adv_loss(f),
                      lambda mu, sig, f, r, a, b: losses.generator_adv_loss(_bcl(f))),
    "generator_adv_bf16_logits": (
        lambda mu, sig, f, r, a, b: jax_losses.generator_adv_loss(f.astype(jnp.bfloat16)),
        lambda mu, sig, f, r, a, b: losses.generator_adv_loss(_bcl(f).bfloat16())),
    "discriminator_adv": (
        lambda mu, sig, f, r, a, b: jax_losses.discriminator_adv_loss(f, r),
        lambda mu, sig, f, r, a, b: losses.discriminator_adv_loss(_bcl(f), _bcl(r))),
    "discriminator_adv_bf16_logits": (
        lambda mu, sig, f, r, a, b: jax_losses.discriminator_adv_loss(f.astype(jnp.bfloat16),
                                                                      r.astype(jnp.bfloat16)),
        lambda mu, sig, f, r, a, b: losses.discriminator_adv_loss(_bcl(f).bfloat16(),
                                                                  _bcl(r).bfloat16())),
    "fft_amplitude": (
        lambda mu, sig, f, r, a, b: jnp.transpose(jax_losses.fft_amplitude(a, axis=-2), (0, 2, 1)),
        lambda mu, sig, f, r, a, b: losses.fft_amplitude(_bcl(a))),
    "jukebox_sum": (lambda mu, sig, f, r, a, b: jax_losses.jukebox_loss(a, b, reduction="sum"),
                    lambda mu, sig, f, r, a, b: losses.jukebox_loss(_bcl(a), _bcl(b))),
    "jukebox_mean": (
        lambda mu, sig, f, r, a, b: jax_losses.jukebox_loss(a, b, reduction="mean"),
        lambda mu, sig, f, r, a, b: losses.jukebox_loss(_bcl(a), _bcl(b), reduction="mean")),
}


@pytest.mark.parametrize("name", LOSS_CASES)
def test_loss_matches_jax(name):
    jax_fn, port_fn = LOSS_CASES[name]
    args = _loss_inputs()
    want = np.asarray(jax_fn(*[jnp.asarray(a) for a in args]))
    got = port_fn(*args)
    assert got.dtype == torch.float32
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_jukebox_loss_rejects_unknown_reduction():
    a = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError):
        losses.jukebox_loss(a, a, reduction="max")


# -- discriminator -------------------------------------------------------------

@pytest.mark.parametrize("length,kernel,stride", [(256, 3, 2), (257, 3, 2), (64, 3, 1),
                                                  (33, 4, 2), (10, 5, 3)])
def test_same_padding_is_flax_same(length, kernel, stride):
    want = jax.lax.padtype_to_pads((length,), (kernel,), (stride,), "SAME")[0]
    assert same_padding(length, kernel, stride) == tuple(want)


# an even length that halves twice to an even one (flax's SAME pads the
# stride-2 convs (0, 1)), and an odd one (padded (1, 1))
@pytest.mark.parametrize("length", [200, 201])
def test_discriminator_matches_jax(setup, length):
    """Every block's output of a train-mode pass whose statistics update is
    kept, and the running mean and biased variance after it."""
    s = setup
    variables = {"params": s["params_d"], "batch_stats": s["stats"]}
    x = s["x"][:, :length]
    outs, mut = jax.jit(lambda v, a: s["disc"].apply(v, a, train=True,
                                                     mutable=["batch_stats"]))(variables, x)
    _, disc = _port_models(s)
    with torch.no_grad():
        got = disc(_bcl(x), update_stats=True)
    assert len(got) == len(outs) == 5
    for g, w in zip(got, outs):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 2, 1), rtol=RTOL,
                                   atol=ATOL)
    want_stats = _disc_state(s["params_d"], mut["batch_stats"])
    for k, v in disc.state_dict().items():
        if _is_buffer(k):
            np.testing.assert_allclose(v.numpy(), want_stats[k], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL, err_msg=k)


def test_discriminator_moves_its_statistics_only_when_asked(setup):
    _, disc = _port_models(setup)
    before = {k: v.clone() for k, v in disc.state_dict().items() if _is_buffer(k)}
    with torch.no_grad():
        disc(_bcl(setup["x"]))
    for k, v in before.items():
        torch.testing.assert_close(disc.state_dict()[k], v, rtol=0, atol=0)


# -- one training step -----------------------------------------------------------

@pytest.mark.parametrize("spectral", [False, True])
def test_step_gradients_match_jax(setup, spectral):
    """SGD at lr 1: p_old - p_new is each parameter's gradient, of G from
    the G loss and of D from the D loss (0.01 of the adversarial loss, so
    small), held at the model bound and, apart, within 2e-3 of its leaf's
    largest; the metrics; the BatchNorm running statistics after the D
    step."""
    (want_m, want_g, want_d), (got_m, got_g, got_d) = _run(setup, "sgd", spectral)
    old_g, old_d = _old(setup)
    assert set(got_m) == set(want_m) == set(A.METRICS)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert want_m["recons_loss"] > 0.1 and want_m["gen_loss"] > 0.1
    assert set(got_g) == set(want_g) and set(got_d) == set(want_d)
    for old, want, got, least in ((old_g, want_g, got_g, 0.1), (old_d, want_d, got_d, 1e-4)):
        grads = {k: old[k] - want[k] for k in want if not _is_buffer(k)}
        assert max(float(np.abs(g).max()) for g in grads.values()) > least
        for k, g in grads.items():
            mine = old[k] - got[k]
            np.testing.assert_allclose(mine, g, rtol=RTOL, atol=ATOL, err_msg=k)
            assert np.abs(mine - g).max() <= RTOL * np.abs(g).max(), k
    for k in want_d:
        if _is_buffer(k):
            assert not np.array_equal(want_d[k], old_d[k]), k
            np.testing.assert_allclose(got_d[k], want_d[k], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("spectral", [False, True])
def test_step_with_adam_matches_jax(setup, spectral):
    """The configuration's two Adams (5e-3 for G, 5e-4 for D): metrics and
    BatchNorm statistics as above; the parameters at the model bound,
    leaving out the entries whose gradient is below 1e-3 of its leaf's
    largest (their update's sign is a rounding's)."""
    (want_m, want_g, want_d), (got_m, got_g, got_d) = _run(setup, "adam", spectral)
    (_, sgd_g, sgd_d), _ = _run(setup, "sgd", spectral)
    old_g, old_d = _old(setup)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=RTOL, atol=ATOL, err_msg=k)
    left_out = total = 0
    for old, sgd, want, got in ((old_g, sgd_g, want_g, got_g), (old_d, sgd_d, want_d, got_d)):
        for k in want:
            if _is_buffer(k):
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                           err_msg=k)
                continue
            g = np.abs(old[k] - sgd[k])
            keep = g >= 1e-3 * g.max()
            left_out, total = left_out + int((~keep).sum()), total + keep.size
            np.testing.assert_allclose(got[k][keep], want[k][keep], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
            assert not np.allclose(want[k][keep], old[k][keep]), k
    assert left_out <= 0.02 * total, (left_out, total)


def test_eval_step_matches_jax(setup):
    """Per-sample L1 of the reconstruction through the posterior mean."""
    s = setup
    l1_j, recon_j = jax_make_eval_step(s["ae"])(s["params_g"], jnp.asarray(s["x"]))
    ae, _ = _port_models(s)
    l1, recon = A.make_eval_step(ae)(_bcl(s["x"]))
    assert l1.shape == (B,) and float(np.asarray(l1_j).min()) > 0.01
    np.testing.assert_allclose(l1.numpy(), np.asarray(l1_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(recon.numpy().transpose(0, 2, 1), np.asarray(recon_j), rtol=RTOL,
                               atol=ATOL)


# -- weights ---------------------------------------------------------------------

def test_aekl_weights_round_trip_to_jax(setup):
    """aekl_state_to_jax inverts aekl_state_from_jax exactly, on every key,
    from numpy arrays and from tensors."""
    tree = jax.device_get(setup["params_g"])
    sd = weights.aekl_state_from_jax(tree)
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    for state in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        back = weights.aekl_state_to_jax(state)
        flat_back = {jax.tree_util.keystr(p): v
                     for p, v in jax.tree_util.tree_leaves_with_path(back)}
        assert set(flat_back) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(flat_back[k], v, err_msg=k)


def test_init_matches_jax_initialisers(setup):
    """The port's initial AEKL and discriminator weights: zero and one
    exactly where the JAX initialisers give them (biases, GroupNorm and
    BatchNorm scales, running mean 0 and variance 1), kernels with the
    JAX kernels' spread."""
    s = setup
    jax_g = weights.aekl_state_from_jax(jax.device_get(s["state"].params_g))
    jax_d = _disc_state(s["state"].params_d, s["state"].batch_stats_d)
    _, cfg = _configs(False)
    ae, disc = A.build_models(cfg)
    for mine, ref in ((weights.lecun_normal_state(ae, 0), jax_g),
                      (weights.lecun_normal_state(disc, [0, 1]), jax_d)):
        assert set(mine) == set(ref)
        for k, v in ref.items():
            if v.ndim < 2:
                np.testing.assert_array_equal(mine[k], v, err_msg=k)
            else:
                assert v.any() and mine[k].any(), k
                if v.size >= 16:
                    assert abs(mine[k].std() / v.std() - 1.0) < 0.5, k


def test_trainer_builds_from_the_configuration():
    _, cfg = _configs(False)
    ae, disc, opt_g, opt_d = A.build_trainer(cfg, "cpu")
    assert opt_g.param_groups[0]["lr"] == cfg.losses.optimizer_g_lr == 5e-3
    assert opt_d.param_groups[0]["lr"] == cfg.losses.optimizer_d_lr == 5e-4
    assert all(p.dtype == torch.float32 for p in [*ae.parameters(), *disc.parameters()])
    assert disc.layer_2_conv.stride == (1,) and disc.layer_1_conv.stride == (2,)
    assert disc.final_conv.out_channels == 1 and disc.layer_2_bn.weight.shape == (8 * DISC_CH,)
    assert disc.num_layers_d == cfg.discriminator.num_layers_d == 3


# -- the smoke's card-vs-CPU hold of the tiny stage-1 trainer ---------------------

def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_g_update(ae, disc, opt_g, opt_d):
    opt_g.step = lambda: None


def _gradients_scaled(ae, disc, opt_g, opt_d):
    for p in ae.parameters():  # Adam's update hardly changes: only the gradients show it
        p.register_hook(lambda g: 1.1 * g)


def _no_statistics(ae, disc, opt_g, opt_d):
    for l in range(disc.num_layers_d):
        bn = getattr(disc, f"layer_{l}_bn")
        bn.forward = lambda x, update_stats=False, f=bn.forward: f(x)


@pytest.mark.parametrize("fault,caught", [
    (None, None), (_no_g_update, "change of ae."), (_gradients_scaled, "gradient ae."),
    (_no_statistics, "change of disc.layer_0_bn.running_")])
def test_smoke_stage1_hold_catches_a_broken_step(monkeypatch, fault, caught):
    """``chip_smoke.hold_tiny_stage1``, the smoke's card-vs-CPU check of two
    tiny stage-1 steps, run here CPU against CPU: it passes two equal runs
    and fails a run whose G update was left out, whose AEKL gradients are
    10 % off, or whose BatchNorm statistics never moved."""
    smoke = _smoke()
    cfg = smoke.tiny_stage1_config()
    rng = np.random.default_rng(31)
    x = rng.uniform(size=(4, 1, 256)).astype(np.float32)
    eps = [rng.standard_normal((4, 1, 64)).astype(np.float32) for _ in range(2)]
    want = smoke.tiny_stage1_run(cfg, "cpu", x, eps)
    if fault is not None:
        build = smoke.A.build_trainer

        def broken(*a, **kw):
            parts = build(*a, **kw)
            fault(*parts)
            return parts

        monkeypatch.setattr(smoke.A, "build_trainer", broken)
    got = smoke.tiny_stage1_run(cfg, "cpu", x, eps)
    if caught is None:
        held = smoke.hold_tiny_stage1(got, want)
        assert held["grad_err_ratio"] == held["update_err_ratio"] == 0.0
        assert 0 < held["left_out"] < 0.05 * held["entries"]
    else:
        with pytest.raises(AssertionError, match=caught):
            smoke.hold_tiny_stage1(got, want)
