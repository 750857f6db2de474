"""The port's first-generation trainers against the JAX package, on the CPU
in fp32, at tiny widths: AutoencoderKLV1 n_channels 8, ch_mult (1, 2), one
resblock per level, G 4, embed_dim 1; DiscriminatorV1 ndf 8, 2 layers; a
UNet of model_channels 8, channel_mult (1, 2), attention at ds 2, G 4;
windows of L 256, batch 4. Weights are drawn from numpy (and the
BatchNorm running statistics set away from 0 and 1), carried into the port
with ``sleepgen_torch.utils.weights``; each step gets JAX's own draws.

Bounds: the losses at rtol 1e-5; gradients within 2e-3 of each leaf's
largest; the BatchNorm running statistics at rtol 1e-5 / atol 1e-6. The
encoder step is held three ways against ``make_v1_encoder_train_step``:
plain SGD at lr 1 (``p_old - p_new`` is the gradient) for each model's
gradient norm; optax's ``chain(clip_by_global_norm(1.0), sgd(1.0))``
for the clipped gradients (the clip's scale); and the trainers' own
``chain(clip_by_global_norm(1.0), adam(lr))`` for what the two Adams do,
each with the adversarial weight at 1.0, so that both clips act
(entries whose gradient is below 1e-3 of their leaf's largest left out,
as Adam's first update takes their sign from a rounding). The DDPM step
likewise, with SGD at lr 1 and with Adam at 2.5e-5. Then both trainers end
to end on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sleepgen.diffusion.ddpm_v1 import DDPMTables as JaxTables
from sleepgen.nn.aekl_v1 import AutoencoderKLV1 as JaxAEKLV1
from sleepgen.nn.discriminator import DiscriminatorV1 as JaxDiscV1
from sleepgen.nn.unet1d import UNet1d as JaxUNet
from sleepgen.train.train_v1 import init_v1_encoder_state as jax_init_state
from sleepgen.train.train_v1 import make_v1_ddpm_train_step as jax_ddpm_step
from sleepgen.train.train_v1 import make_v1_encoder_train_step as jax_encoder_step
from sleepgen.utils import jit_init
from sleepgen_torch.data.synthetic import make_synthetic_dataset
from sleepgen_torch.data.dataset import WindowDataset
from sleepgen_torch.diffusion.ddpm_v1 import DDPMTables
from sleepgen_torch.nn.aekl_v1 import AutoencoderKLV1
from sleepgen_torch.nn.discriminator import DiscriminatorV1
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.train import train_v1 as V
from sleepgen_torch.utils import weights

from test_torch_port_parity import _randomize

B, L, LATENT = 4, 256, 128
AE_KW = dict(embed_dim=1, n_channels=8, z_channels=1, ch_mult=(1, 2), num_res_blocks=1,
             resolution=L, num_groups=4)
DISC_KW = dict(ndf=8, n_layers=2)
UNET_KW = dict(in_channels=1, out_channels=1, model_channels=8, channel_mult=(1, 2),
               attention_resolutions=(2,), num_groups=4)
LOSS_RTOL, GRAD_FRAC = 1e-5, 2e-3
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: its models are tiny,
    and the suite runs several worker processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bcl(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


@pytest.fixture(scope="module")
def enc():
    """JAX modules and state, numpy-drawn weights and statistics, a batch,
    the step's rng and the eps the JAX step draws from it."""
    ae, disc = JaxAEKLV1(**AE_KW), JaxDiscV1(**DISC_KW)
    state, _, _ = jax_init_state(ae, disc, jax.random.PRNGKey(0), window=L)
    rng = np.random.default_rng(90)
    stats = {k: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
                 "var": (1.0 + 0.2 * rng.random(s["var"].shape)).astype(np.float32)}
             for k, s in jax.device_get(state.batch_stats_d).items()}
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(jax.random.fold_in(key, 0), (B, LATENT, 1)))
    return dict(ae=ae, disc=disc, state=state, params_g=_randomize(state.params_g, 91),
                params_d=_randomize(state.params_d, 92), stats=stats, key=key, eps=eps,
                x=rng.uniform(size=(B, L, 1)).astype(np.float32))


def _leaves(tree) -> dict:
    """A flax tree flat by key path. The G side is compared leaf by leaf of
    the JAX tree: its fused qkv bias holds the k bias, whose gradient is a
    rounding's (softmax ignores a shift of k), beside the q and v biases."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(jax.device_get(tree))}


def _disc_sd(params, stats):
    return weights.discriminator_v1_state_from_jax(
        {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)})


_RUNS = {}


def _jax_encoder_run(s, opt_g, opt_d, gan_weight):
    pg, pd = s["params_g"], s["params_d"]
    state = jax.tree_util.tree_map(jnp.array, s["state"].replace(
        params_g=pg, opt_g=opt_g.init(pg), params_d=pd, batch_stats_d=s["stats"],
        opt_d=opt_d.init(pd)))
    new, m = jax_encoder_step(s["ae"], s["disc"], opt_g, opt_d, gan_weight=gan_weight)(
        state, jnp.asarray(s["x"]), s["key"])
    return ({k: float(v) for k, v in m.items()}, _leaves(new.params_g),
            _disc_sd(new.params_d, new.batch_stats_d))


def _port_encoder_run(s, opt: str, gan_weight):
    ae = weights.load_numpy_state(AutoencoderKLV1(**AE_KW),
                                  weights.aekl_v1_state_from_jax(s["params_g"]))
    disc = weights.load_numpy_state(DiscriminatorV1(**DISC_KW),
                                    _disc_sd(s["params_d"], s["stats"]))
    if opt == "sgd":
        opt_g, opt_d = (torch.optim.SGD(m.parameters(), lr=1.0) for m in (ae, disc))
    else:
        opt_g = torch.optim.Adam(ae.parameters(), lr=1e-4)
        opt_d = torch.optim.Adam(disc.parameters(), lr=5e-4)
    state = V.V1EncoderState(ae, disc, opt_g, opt_d)
    m = V.make_v1_encoder_train_step(state, gan_weight=gan_weight)(_bcl(s["x"]),
                                                                   _bcl(s["eps"]))
    assert state.step == 1
    return ({k: float(v) for k, v in m.items()},
            _leaves(weights.aekl_v1_state_to_jax(ae.state_dict())),
            {k: v.numpy().copy() for k, v in disc.state_dict().items()})


def _encoder_runs(s, case):
    """(JAX, port) of one case, each at adversarial weight 1.0 (so that the
    discriminator's gradient norm, about 0.03 at the trainers' 0.01, passes
    the clip): "raw" (JAX plain SGD; no port run), "clip" (SGD behind the
    clip), "adam" (the trainers' optimisers)."""
    if case not in _RUNS:
        clip = optax.clip_by_global_norm(1.0)
        if case == "raw":
            _RUNS[case] = _jax_encoder_run(s, optax.sgd(1.0), optax.sgd(1.0), 1.0), None
        elif case == "clip":
            sgd = optax.chain(clip, optax.sgd(1.0))
            _RUNS[case] = (_jax_encoder_run(s, sgd, sgd, 1.0), _port_encoder_run(s, "sgd", 1.0))
        else:
            _RUNS[case] = (_jax_encoder_run(s, optax.chain(clip, optax.adam(1e-4)),
                                            optax.chain(clip, optax.adam(5e-4)), 1.0),
                           _port_encoder_run(s, "adam", 1.0))
    return _RUNS[case]


def _old(s):
    return _leaves(s["params_g"]), _disc_sd(s["params_d"], s["stats"])


def _is_stat(k):
    return k.endswith(("running_mean", "running_var"))


def _hold_grads(old, new_want, new_got, what):
    for k, o in old.items():
        if _is_stat(k):
            continue
        want, got = o - new_want[k], o - new_got[k]
        top = float(np.abs(want).max())
        assert top > 0, f"{what} {k}: no gradient"
        err = float(np.abs(got - want).max())
        assert err <= GRAD_FRAC * top, f"{what} {k}: |err| {err:.3e}, largest |g| {top:.3e}"


@pytest.mark.parametrize("case", ["clip", "adam"])
def test_encoder_step_losses_match_jax(enc, case):
    (want, _, _), (got, _, _) = _encoder_runs(enc, case)
    for k in V.ENCODER_METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_encoder_step_grad_norms_match_jax(enc):
    """The port's norms before the clip are the global norms of JAX's raw
    gradients (plain SGD at lr 1), and both exceed the clip, so the clip
    case below scales both models' gradients."""
    (_, raw_g, raw_d), _ = _encoder_runs(enc, "raw")
    (_, (got, _, _)) = _encoder_runs(enc, "clip")
    old_g, old_d = _old(enc)
    for name, old, new in (("grad_norm_g", old_g, raw_g), ("grad_norm_d", old_d, raw_d)):
        norm = float(np.sqrt(sum(float(np.sum((old[k] - new[k]).astype(np.float64) ** 2))
                                 for k in old if not _is_stat(k))))
        assert norm > 1.0, name
        np.testing.assert_allclose(got[name], norm, rtol=1e-4, err_msg=name)


def test_encoder_step_clipped_gradients_match_jax(enc):
    """Behind optax's clip, SGD at lr 1 moves each parameter by its
    gradient times min(1, 1 / ||g||): the port's move equals JAX's."""
    (_, want_g, want_d), (_, got_g, got_d) = _encoder_runs(enc, "clip")
    old_g, old_d = _old(enc)
    _hold_grads(old_g, want_g, got_g, "G")
    _hold_grads(old_d, want_d, got_d, "D")
    for k in old_d:  # the fake pass's statistics threaded into the real pass's
        if _is_stat(k):
            np.testing.assert_allclose(got_d[k], want_d[k], rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=k)
            assert not np.array_equal(got_d[k], old_d[k]), k


def test_clip_by_global_norm_is_optax_formula():
    """g * min(1, c / ||g||), with no 1e-6 added to the norm."""
    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for c in (0.5, 100.0):
        params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in leaves]
        for p, v in zip(params, leaves):
            p.grad = torch.from_numpy(v.copy())
        norm = V.clip_by_global_norm_(params, c)
        want = optax.clip_by_global_norm(c).update([jnp.asarray(v) for v in leaves], None)[0]
        np.testing.assert_allclose(float(norm), float(optax.global_norm(leaves)), rtol=1e-6)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_encoder_step_adam_matches_jax(enc):
    """What the clipped Adams changed, new - old, within 1e-2 of each leaf's
    largest change, leaving out the entries whose (raw) gradient is below
    1e-3 of their leaf's largest; the BatchNorm statistics at their bound."""
    (_, raw_g, raw_d), _ = _encoder_runs(enc, "raw")
    (_, want_g, want_d), (_, got_g, got_d) = _encoder_runs(enc, "adam")
    old_g, old_d = _old(enc)
    for old, raw, want, got in ((old_g, raw_g, want_g, got_g), (old_d, raw_d, want_d, got_d)):
        for k, o in old.items():
            if _is_stat(k):
                np.testing.assert_allclose(got[k], want[k], rtol=STATS_RTOL, atol=STATS_ATOL,
                                           err_msg=k)
                continue
            g = np.abs(o - raw[k])
            keep = g >= 1e-3 * g.max()
            change, mine = want[k] - o, got[k] - o
            top = float(np.abs(change).max())
            err = float(np.abs(mine - change)[keep].max(initial=0.0))
            assert top > 0 and err <= 1e-2 * top, f"{k}: |err| {err:.3e}, top {top:.3e}"


@pytest.fixture(scope="module")
def ddpm():
    ae = JaxAEKLV1(**AE_KW)
    rng = jax.random.PRNGKey(3)
    ae_params = _randomize(jit_init(ae, {"params": rng}, jnp.zeros((2, L, 1)), rng)["params"],
                           93)
    unet = JaxUNet(**UNET_KW)
    params = _randomize(jit_init(unet, rng, jnp.zeros((2, LATENT, 1)),
                                 jnp.zeros((2,), jnp.int32))["params"], 94)
    x = np.random.default_rng(95).uniform(size=(B, L, 1)).astype(np.float32)
    key, step = jax.random.PRNGKey(11), 3
    k_enc, k_t, k_noise = jax.random.split(jax.random.fold_in(key, step), 3)
    draws = (jax.random.normal(k_enc, (B, LATENT, 1), jnp.float32),
             jax.random.randint(k_t, (B,), 0, 1000),
             jax.random.normal(k_noise, (B, LATENT, 1), jnp.float32))
    return dict(ae=ae, ae_params=ae_params, unet=unet, params=params, x=x, key=key, step=step,
                draws=draws)


def _ddpm_runs(s, opt: str):
    key = ("ddpm", opt)
    if key in _RUNS:
        return _RUNS[key]
    tbl = JaxTables.create("linear", 1000, 0.0015, 0.0195)
    jopt = optax.sgd(1.0) if opt == "sgd" else optax.adam(2.5e-5)
    params = jax.tree_util.tree_map(jnp.array, s["params"])
    new, _, m = jax_ddpm_step(tbl, s["unet"], s["ae"], s["ae_params"], jopt)(
        params, jopt.init(params), s["step"], jnp.asarray(s["x"]), s["key"])
    want = ({k: float(v) for k, v in m.items()},
            weights.unet_state_from_jax(jax.device_get(new)))

    unet = weights.load_numpy_state(UNet1d(**UNET_KW), weights.unet_state_from_jax(s["params"]))
    ae = weights.load_numpy_state(AutoencoderKLV1(**AE_KW),
                                  weights.aekl_v1_state_from_jax(s["ae_params"])).eval()
    popt = (torch.optim.SGD(unet.parameters(), lr=1.0) if opt == "sgd"
            else torch.optim.Adam(unet.parameters(), lr=2.5e-5))
    eps, t, noise = s["draws"]
    pm = V.make_v1_ddpm_train_step(DDPMTables.create("linear", 1000, 0.0015, 0.0195), unet,
                                   ae, popt)(_bcl(s["x"]), _bcl(eps),
                                             torch.from_numpy(np.asarray(t)).long(),
                                             _bcl(noise))
    got = ({k: float(v) for k, v in pm.items()},
           {k: v.numpy().copy() for k, v in unet.state_dict().items()})
    _RUNS[key] = want, got
    return want, got


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_ddpm_step_matches_jax(ddpm, opt):
    (want_m, want), (got_m, got) = _ddpm_runs(ddpm, opt)
    for k in V.DDPM_METRICS:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, err_msg=k)
    old = weights.unet_state_from_jax(ddpm["params"])
    if opt == "sgd":
        _hold_grads(old, want, got, "UNet")
        return
    (_, raw) = _ddpm_runs(ddpm, "sgd")[0]
    for k, o in old.items():
        g = np.abs(o - raw[k])
        keep = g >= 1e-3 * g.max()
        change, mine = want[k] - o, got[k] - o
        top = float(np.abs(change).max())
        err = float(np.abs(mine - change)[keep].max(initial=0.0))
        assert top > 0 and err <= 1e-2 * top, f"{k}: |err| {err:.3e}, top {top:.3e}"


def test_draw_v1_ddpm_inputs_order_and_range():
    gen = torch.Generator().manual_seed(5)
    eps, t, noise = V.draw_v1_ddpm_inputs(gen, 6, (1, 16), 1000)
    ref = torch.Generator().manual_seed(5)
    torch.testing.assert_close(eps, torch.randn((6, 1, 16), generator=ref), rtol=0, atol=0)
    torch.testing.assert_close(t, torch.randint(0, 1000, (6,), generator=ref), rtol=0, atol=0)
    torch.testing.assert_close(noise, torch.randn((6, 1, 16), generator=ref), rtol=0, atol=0)


def test_v1_trainers_end_to_end(tmp_path):
    """train_v1_encoder then train_v1_ddpm over its final model, on the CPU:
    the run dirs, finite losses, and run dirs that both packages read."""
    from sleepgen_torch.utils.weights import load_params_npz

    raws = make_synthetic_dataset(6, duration_s=30.0)
    train = WindowDataset.from_raw(raws[:4], window=248, pad=4)
    valid = WindowDataset.from_raw(raws[4:], window=248, pad=4)
    kw = dict(n_channels=4, embed_dim=1, z_channels=1, ch_mult=(1, 2), num_groups=4)
    best, state = V.train_v1_encoder(train, valid, tmp_path / "enc", n_epochs=2, batch_size=2,
                                     val_interval=1, device="cpu", **kw)
    assert np.isfinite(best) and state.step == 4
    for name in ("best_model/params.npz", "final_model/params.npz", "metrics_train.jsonl",
                 "checkpoints/step_00000002.pt"):
        assert (tmp_path / "enc" / name).exists(), name
    tree = load_params_npz(tmp_path / "enc" / "final_model" / "params.npz")
    jax_ae = JaxAEKLV1(embed_dim=1, n_channels=4, z_channels=1, ch_mult=(1, 2), resolution=256,
                       num_groups=4)
    z_mu, _ = jax_ae.apply({"params": tree}, jnp.zeros((1, 256, 1)), method=JaxAEKLV1.encode)
    assert z_mu.shape == (1, 128, 1)

    ae = AutoencoderKLV1(resolution=256, **kw)
    stage1 = weights.aekl_v1_state_from_jax(tree)
    unet = UNet1d(**{**UNET_KW, "model_channels": 8})
    trained = V.train_v1_ddpm(train, stage1, tmp_path / "ddpm", ae, n_epochs=2, batch_size=2,
                              timesteps=50, unet=unet, device="cpu")
    assert trained is unet
    lines = (tmp_path / "ddpm" / "metrics_train.jsonl").read_text().splitlines()
    assert len(lines) == 2
    assert (tmp_path / "ddpm" / "final_model" / "params.npz").exists()
    assert not (tmp_path / "ddpm" / "best_model").exists()
    weights.load_numpy_state(UNet1d(**UNET_KW), weights.unet_state_from_jax(
        load_params_npz(tmp_path / "ddpm" / "final_model" / "params.npz")))
