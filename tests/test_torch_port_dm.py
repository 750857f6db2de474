"""The port's signal-space DM against the JAX package, on the CPU, and its
train-dm / sample-dm CLIs.

Tiny widths, fp32: UNet1d model_channels 32, channel_mult (1, 2),
attention at ds 2, G 8, on one channel at L 256 (the DM's geometry, cut
in length), unconditional and with 5 classes; every weight leaf drawn
from numpy (test_torch_port_parity's ``_randomize``) and carried into the
port with ``sleepgen_torch.utils.weights``. The random draws of a step
(t, the noise, the label dropout) are rebuilt with ``jax.random`` in the
JAX trainer's order (``fold_in(rng, step)`` split three ways) and handed
to the port. Schedules have at most 16 timesteps. Bound: the model bound
of tests/test_torch_import.py (rtol 2e-3 / atol 2e-4) unless a test
states another.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sleepgen.data.staging import LabeledEpochDataset as JaxLabeledEpochDataset
from sleepgen.diffusion import NoiseSchedule as JaxSchedule
from sleepgen.losses import jukebox_loss as jax_jukebox_loss
from sleepgen.nn import UNet1d as JaxUNet
from sleepgen.sample import samplers as jax_samplers
from sleepgen.sample.sample_ldm import make_dm_sampler as jax_make_dm_sampler
from sleepgen.train.train_dm import (DM_SPECTRAL_WEIGHT, make_dm_eval_step as jax_dm_eval_step,
                                    make_dm_train_step as jax_dm_train_step)
from sleepgen.train.train_ldm import DiffusionState
from sleepgen.utils import jit_init
from sleepgen_torch.config import Config
from sleepgen_torch.data.staging import LabeledEpochDataset
from sleepgen_torch.diffusion import schedules
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.sample import sample_ldm, samplers
from sleepgen_torch.train import train_dm as D
from sleepgen_torch.utils import weights

from test_torch_port_parity import UNET_KW, _randomize

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


L = 256  # signal length of the tiny DM
N_CLASSES = 5
B = 3


def _jax_dm(num_classes, seed):
    m = JaxUNet(num_groups=8, num_classes=num_classes, **UNET_KW)
    args = (jax.random.PRNGKey(0), jnp.zeros((2, L, 1)), jnp.zeros((2,), jnp.int32))
    if num_classes:
        args += (jnp.zeros((2,), jnp.int32),)
    return m, _randomize(jit_init(m, *args)["params"], seed)


def _port_dm(params, num_classes=0):
    m = UNet1d(num_groups=8, num_classes=num_classes, **UNET_KW)
    return weights.load_numpy_state(m, weights.unet_state_from_jax(params))


@pytest.fixture(scope="module")
def dm():
    return _jax_dm(0, 50)


@pytest.fixture(scope="module")
def cond_dm():
    return _jax_dm(N_CLASSES, 51)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _bcl(a):
    return _t(np.asarray(a).transpose(0, 2, 1))


def _train_schedules(timesteps=16):
    args = ("linear_beta", timesteps, 0.0015, 0.0195)
    return (JaxSchedule.create(*args, prediction_type="epsilon"),
            schedules.NoiseSchedule.create(*args, prediction_type="epsilon"))


def _windows(seed=60, n=B):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=(n, L, 1)).astype(np.float32)


def _jax_step_draws(rng, step, x, y, js, drop_prob):
    """The JAX trainer's draws of one step, in its order."""
    k_t, k_noise, k_drop = jax.random.split(jax.random.fold_in(rng, step), 3)
    t = jax.random.randint(k_t, (x.shape[0],), 0, js.num_timesteps)
    noise = jax.random.normal(k_noise, x.shape, jnp.float32)
    drop = jax.random.bernoulli(k_drop, drop_prob, y.shape) if drop_prob > 0 else None
    return t, noise, drop


_LOSS_AND_GRADS = {}


def _jax_loss_and_grads(jm, js):
    """jax.value_and_grad of the DM loss composed from the JAX package's
    pieces (add_noise, the UNet, the MSE, plus ``weight`` x the Jukebox
    loss of pred against the target along the length axis), jitted once
    per UNet: the spectral weight is an argument, not a constant."""
    if jm not in _LOSS_AND_GRADS:
        def loss_fn(p, x, t, noise, y, weight):
            pred = jm.apply({"params": p}, js.add_noise(x, noise, t), t, y)
            pred = pred.astype(jnp.float32)
            spec = jax_jukebox_loss(pred, noise, axis=-2, reduction="sum")
            return jnp.mean((pred - noise) ** 2) + weight * spec

        _LOSS_AND_GRADS[jm] = jax.jit(jax.value_and_grad(loss_fn))
    return _LOSS_AND_GRADS[jm]


CASES = {"plain": (False, False, 0.0), "spectral": (True, False, 0.0),
         "label_dropout": (False, True, 0.5)}


@pytest.mark.parametrize("case", CASES)
def test_dm_train_step_matches_jax(dm, cond_dm, case):
    """One DM step: the loss and every gradient against jax.value_and_grad
    of the same pieces (add_noise, the UNet, the MSE, plus 1e-6 x the
    Jukebox loss of pred against the target along the length axis when
    spectral), then Adam's update on those gradients; with labels, the
    loss and the updated parameters against JAX's own
    ``make_dm_train_step``, fed the same batch and key, which draws the
    label dropout itself."""
    spectral, conditional, drop_prob = CASES[case]
    jm, params = cond_dm if conditional else dm
    js, ps = _train_schedules()
    x = _windows()
    y = np.array([4, 0, 2], np.int32)
    rng = jax.random.PRNGKey(7)
    t, noise, drop = _jax_step_draws(rng, 0, x, jnp.asarray(y), js, drop_prob)
    if conditional:
        assert bool(drop.any()) and not bool(drop.all())
    y_used = jnp.where(drop, -1, jnp.asarray(y)) if drop is not None else jnp.asarray(y)
    want_loss, want_grads_tree = _jax_loss_and_grads(jm, js)(
        params, jnp.asarray(x), t, noise, y_used if conditional else None,
        DM_SPECTRAL_WEIGHT if spectral else 0.0)
    want_grads = weights.unet_state_from_jax(jax.device_get(want_grads_tree))

    unet = _port_dm(params, N_CLASSES if conditional else 0)
    opt = torch.optim.Adam(unet.parameters(), lr=1e-4)
    step = D.make_dm_train_step(unet, ps, opt, spectral)
    out = step(_bcl(x), _t(t).long(), _bcl(noise), _t(y).long() if conditional else None,
               _t(drop) if drop is not None else None)
    np.testing.assert_allclose(float(out["loss"]), float(want_loss), rtol=RTOL, atol=ATOL)
    grads = dict(unet.named_parameters())
    assert set(grads) == set(want_grads)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), g, rtol=RTOL, atol=ATOL, err_msg=k)

    opt_j = optax.adam(1e-4)
    if conditional:  # JAX's own step, which draws the dropout itself
        state = DiffusionState(step=jnp.zeros((), jnp.int32), params=params,
                               opt=opt_j.init(params), best_loss=jnp.asarray(jnp.inf),
                               scale_factor=jnp.asarray(1.0))
        jax_step = jax_dm_train_step(jm, js, opt_j, spectral, conditional=True,
                                     cond_dropout_prob=drop_prob)
        new_state, metrics = jax_step(state, (jnp.asarray(x), jnp.asarray(y)), rng)
        np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=RTOL,
                                   atol=ATOL)
        new = weights.unet_state_from_jax(jax.device_get(new_state.params))
    else:
        # Adam's first step from zero moments, bias-corrected: -lr g / (|g| + eps)
        # (test_torch_port_train.py::test_adam_matches_optax holds the
        # port's Adam to optax over several steps)
        start = weights.unet_state_from_jax(params)
        new = {k: start[k] - 1e-4 * g / (np.abs(g) + 1e-8) for k, g in want_grads.items()}
    for k, p in unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("conditional", [False, True], ids=["plain", "conditional"])
def test_dm_eval_step_matches_jax(dm, cond_dm, conditional):
    jm, params = cond_dm if conditional else dm
    js, ps = _train_schedules()
    x = _windows(61)
    y = np.array([1, 3, 0], np.int32)
    rng = jax.random.PRNGKey(8)
    batch = (jnp.asarray(x), jnp.asarray(y)) if conditional else jnp.asarray(x)
    want = jax_dm_eval_step(jm, js, conditional=conditional)(params, batch, rng)
    k_t, k_noise = jax.random.split(rng)
    t = jax.random.randint(k_t, (B,), 0, js.num_timesteps)
    noise = jax.random.normal(k_noise, x.shape, jnp.float32)
    unet = _port_dm(params, N_CLASSES if conditional else 0)
    got = D.make_dm_eval_step(unet, ps)(_bcl(x), _t(t).long(), _bcl(noise),
                                        _t(y).long() if conditional else None)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _jax_ddpm_noises(key, steps, shape):
    """The JAX DDPM loop's step noises, in its split order."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_bcl(jax.random.normal(sub, shape, jnp.float32)))
    return out


def test_make_dm_sampler_matches_jax(dm, monkeypatch):
    """DDPM over every timestep of a 12-entry table with clip_sample, from
    the same x_T and the same step noises, cropped by the border pad."""
    jm, params = dm
    js, ps = _train_schedules(12)
    seeds = np.array([3, 9], np.int32)
    base_key, loop_key = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    want = jax_make_dm_sampler(jm, js, signal_len=L)(params, base_key, jnp.asarray(seeds),
                                                     loop_key)
    x_T = jax_samplers.seed_noise(base_key, jnp.asarray(seeds), (L, 1))
    monkeypatch.setattr(sample_ldm, "seed_noise", lambda s, shape, dev: _t(x_T))
    sample = sample_ldm.make_dm_sampler(_port_dm(params).eval(), ps, signal_len=L, device="cpu")
    got = sample(seeds.tolist(), iter(_jax_ddpm_noises(loop_key, 12, (2, L, 1))))
    assert got.shape == (2, L - 72, 1) and float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [1.0, 2.5], ids=["conditional", "guided"])
def test_sample_dm_conditional_matches_jax(cond_dm, monkeypatch, scale):
    """DDIM-4 over the DM's 16-entry sampling table (scaled-linear,
    v-prediction) with labels, plain and guided, from the same x_T."""
    jm, params = cond_dm
    cfg = Config()
    js = JaxSchedule.create(cfg.diffusion.sample_schedule, 16, cfg.diffusion.sample_beta_start,
                            cfg.diffusion.sample_beta_end,
                            prediction_type=cfg.diffusion.sample_prediction_type)
    ps = sample_ldm.dm_sampling_schedule(cfg, 16)
    labels = np.array([2, 0], np.int32)
    seeds = np.array([5, 6], np.int32)
    key = jax.random.PRNGKey(2)
    want = jax_samplers.sample_dm_conditional(jm, params, js, jnp.asarray(labels), key,
                                              jnp.asarray(seeds), L, num_steps=4,
                                              guidance_scale=scale)
    x_T = jax_samplers.seed_noise(key, jnp.asarray(seeds), (L, 1))
    monkeypatch.setattr(samplers, "seed_noise", lambda s, shape, dev: _t(x_T))
    with torch.no_grad():
        got = samplers.sample_dm_conditional(_port_dm(params, N_CLASSES).eval(), ps,
                                             _t(labels).long(), seeds.tolist(), L, 4, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1),
                               rtol=RTOL, atol=ATOL)


def test_dm_sampling_schedule_matches_jax():
    """The table-length quirk's schedule: scaled-linear v-prediction at the
    caller's table length, as the JAX CLI's ``dm_sampling_schedule``."""
    from sleepgen.cli.sample_trials_ddpm import dm_sampling_schedule as jax_schedule
    from sleepgen.config import Config as JaxConfig

    for n in (16, 200, 1000):
        want = jax_schedule(JaxConfig(), n)
        got = sample_ldm.dm_sampling_schedule(Config(), n)
        assert got.num_timesteps == n and got.prediction_type == "v_prediction"
        np.testing.assert_allclose(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod),
                                   rtol=1e-6)


def test_labeled_epoch_dataset_matches_jax():
    rng = np.random.default_rng(62)
    windows = rng.normal(size=(11, 3000)).astype(np.float32)
    labels = rng.integers(0, 5, 11)
    mine = LabeledEpochDataset(windows, labels)
    ref = JaxLabeledEpochDataset(windows, labels)
    assert (len(mine), mine.padded_window) == (len(ref), ref.padded_window) == (11, 3072)
    for shuffle in (True, False):
        got = list(mine.epoch_batches(4, np.random.default_rng(3), shuffle=shuffle))
        want = list(ref.epoch_batches(4, np.random.default_rng(3), shuffle=shuffle))
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == np.float32 and gy.dtype == np.int32
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_dm_weights_cross_at_one_channel(dm, tmp_path):
    """The DM UNet has the LDM UNet's parameter names: at in_channels 1 its
    flax tree crosses as params.npz into the port (strict) and back, and
    the two forwards agree."""
    jm, params = dm
    path = weights.save_params_npz(tmp_path / "params.npz", {"params": jax.device_get(params)})
    sd = weights.unet_state_from_jax(weights.load_params_npz(path))
    unet = weights.load_numpy_state(UNet1d(num_groups=8, **UNET_KW), sd).eval()
    assert unet.input_blocks[0][0].weight.shape[1] == 1
    back = weights.unet_state_to_jax({k: v.numpy() for k, v in unet.state_dict().items()})
    flat_a, flat_b = (dict(jax.tree_util.tree_flatten_with_path(t)[0]) for t in
                      (jax.device_get(params), back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[k]), np.asarray(flat_a[k]))
    x = _windows(63, 2)
    t = np.array([3, 11], np.int32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = unet(_bcl(x), _t(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1),
                               rtol=RTOL, atol=ATOL)


def test_conditional_ldm_train_step_matches_jax(cond_dm):
    """``make_ldm_train_step`` with labels and label dropout against JAX's
    ``make_ldm_train_step(conditional=True, cond_dropout_prob=0.5)`` on the
    same batch and key (draws rebuilt in its order: the encoder's eps, t,
    the noise, the dropout): loss and updated parameters. The AEKL is a
    tiny [4, 4, 8] over windows of 4 x 64 samples; the UNet runs on the
    latent (length 64)."""
    from sleepgen.nn import AutoencoderKL as JaxAEKL
    from sleepgen.train.train_ldm import make_ldm_train_step as jax_ldm_step
    from sleepgen_torch.nn.aekl import AutoencoderKL
    from sleepgen_torch.train import train_ldm as T

    from test_torch_port_parity import AEKL_CH, LATENT, _jax_unet

    jm, uparams = _jax_unet(N_CLASSES)
    ja = JaxAEKL(num_channels=AEKL_CH, latent_channels=1)
    key = jax.random.PRNGKey(1)
    aparams = _randomize(jit_init(ja, {"params": key}, jnp.zeros((1, 4 * LATENT, 1)), key)
                         ["params"], 52)
    js, ps = _train_schedules()
    x = np.random.default_rng(64).uniform(size=(B, 4 * LATENT, 1)).astype(np.float32)
    y = np.array([1, 4, 3], np.int32)
    sf, rng = 1.3, jax.random.PRNGKey(9)
    opt_j = optax.adam(1e-4)
    state = DiffusionState(step=jnp.zeros((), jnp.int32), params=uparams,
                           opt=opt_j.init(uparams), best_loss=jnp.asarray(jnp.inf),
                           scale_factor=jnp.asarray(sf, jnp.float32))
    step_j = jax_ldm_step(jm, ja, aparams, js, opt_j, conditional=True, cond_dropout_prob=0.5)
    new_state, metrics = step_j(state, (jnp.asarray(x), jnp.asarray(y)), rng)

    k_enc, k_t, k_noise, k_drop = jax.random.split(jax.random.fold_in(rng, 0), 4)
    enc_eps = jax.random.normal(k_enc, (B, LATENT, 1), jnp.float32)
    t = jax.random.randint(k_t, (B,), 0, js.num_timesteps)
    noise = jax.random.normal(k_noise, (B, LATENT, 1), jnp.float32)
    drop = jax.random.bernoulli(k_drop, 0.5, (B,))
    assert bool(drop.any()) and not bool(drop.all())

    unet = _port_dm(uparams, N_CLASSES)
    ae = weights.load_numpy_state(AutoencoderKL(num_channels=AEKL_CH, latent_channels=1),
                                  weights.aekl_state_from_jax(aparams)).requires_grad_(False)
    opt = torch.optim.Adam(unet.parameters(), lr=1e-4)
    loss = T.make_ldm_train_step(unet, ae, ps, opt, sf)(
        _bcl(x), _t(t).long(), _bcl(noise), _bcl(enc_eps), _t(y).long(), _t(drop))
    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=RTOL, atol=ATOL)
    new = weights.unet_state_from_jax(jax.device_get(new_state.params))
    for k, p in unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[k], rtol=RTOL, atol=ATOL, err_msg=k)


# -- the entry points and CLIs ------------------------------------------------

def _dm_config(num_classes=0):
    """The DM's geometry (3072 samples, G 8) at tiny width, fp32, a
    16-entry training table."""
    cfg = Config()
    cfg.dtype = "float32"
    cfg.unet.model_channels, cfg.unet.channel_mult = 16, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.unet.image_size, cfg.unet.num_classes = 3072, num_classes
    cfg.diffusion.timesteps = 16
    cfg.train.n_epochs, cfg.train.batch_size, cfg.train.val_interval = 2, 4, 1
    cfg.train.cond_dropout_prob = 0.3
    return cfg


def _umbrella(monkeypatch, *argv):
    from sleepgen_torch.__main__ import main

    monkeypatch.setattr(sys, "argv", ["sleepgen_torch", *argv])
    return main()


@pytest.fixture(scope="module")
def dm_run(tmp_path_factory):
    """One ``train-dm`` run through the umbrella CLI on a synthetic npy tree
    (6 training, 2 validation recordings of 35 s)."""
    from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree

    root = tmp_path_factory.mktemp("dm")
    cfg = _dm_config()
    cfg.train.output_dir = str(root / "outputs")
    cfg.to_yaml(root / "dm.yaml")
    rows = write_synthetic_npy_tree(root / "npy", n_subjects=4, duration_s=35.0, seed=0)
    write_ids_csv(root / "train.csv", rows[:6])
    write_ids_csv(root / "valid.csv", rows[6:8])
    argv = ["train-dm", "--config_file", str(root / "dm.yaml"), "--path_train_ids",
            str(root / "train.csv"), "--path_valid_ids", str(root / "valid.csv"),
            "--path_pre_processed", str(root / "npy"), "--dtype", "float32", "--device", "cpu"]
    mp = pytest.MonkeyPatch()
    try:
        result = _umbrella(mp, *argv)
    finally:
        mp.undo()
    return root, result


def test_train_dm_cli_writes_the_run_dir(dm_run):
    root, result = dm_run
    run = root / "outputs" / "dm_eeg_no-spectral_edfx"
    assert result.run_dir == str(run)
    for name in ("config.yaml", "metrics_train.jsonl", "metrics_val.jsonl",
                 "best_model/params.npz", "best_model/config.yaml", "final_model/params.npz",
                 "checkpoints/step_00000004.pt"):
        assert (run / name).exists(), name
    assert not (run / "final_model" / "scale_factor.txt").exists()
    train_log = [json.loads(line) for line in (run / "metrics_train.jsonl").read_text()
                 .splitlines()]
    assert [r["step"] for r in train_log] == [0, 1]
    assert len((run / "metrics_val.jsonl").read_text().splitlines()) == 2  # no eval first
    sample = np.load(run / "sample_unconditioned_1.npy")  # every 2 x val_interval
    assert sample.shape == (1, 1, 3072) and np.abs(sample).max() <= 1.0
    assert not (run / "sample_unconditioned_0.npy").exists()
    assert np.isfinite(result.best_loss) and not result.stopped_on_nan


def test_train_dm_conditional_samples_one_window_per_class(tmp_path):
    """``train_dm`` on a LabeledEpochDataset: (x, y) batches, label
    dropout, one in-training sample per class."""
    cfg = _dm_config(N_CLASSES)
    cfg.train.output_dir = str(tmp_path)
    rng = np.random.default_rng(65)
    train = LabeledEpochDataset(rng.uniform(size=(6, 3000)), rng.integers(0, 5, 6))
    valid = LabeledEpochDataset(rng.uniform(size=(3, 3000)), rng.integers(0, 5, 3))
    result = D.train_dm(cfg, train, valid, device="cpu")
    sample = np.load(tmp_path / "dm_eeg_no-spectral_edfx" / "sample_conditional_1.npy")
    assert sample.shape == (N_CLASSES, 1, 3072) and np.isfinite(sample).all()
    assert np.isfinite(result.best_loss)


def test_train_dm_nonfinite_loss_keeps_the_last_finite_model(tmp_path, monkeypatch):
    """A step that turns the loss non-finite in the second epoch stops
    training; final_model/ is the first epoch's finite checkpoint."""
    from sleepgen_torch.data.dataset import WindowDataset
    from sleepgen_torch.data.synthetic import make_synthetic_dataset

    cfg = _dm_config()
    cfg.train.output_dir = str(tmp_path)
    cfg.train.n_epochs = 3
    ds = WindowDataset.from_raw(make_synthetic_dataset(4, 35.0, 0))
    real, calls = D.make_dm_train_step, []

    def poisoned(*a, **kw):
        step = real(*a, **kw)

        def run(x, *rest):
            calls.append(1)
            return step(x * (float("nan") if len(calls) > 1 else 1.0), *rest)
        return run

    monkeypatch.setattr(D, "make_dm_train_step", poisoned)
    result = D.train_dm(cfg, ds, ds, device="cpu")
    assert result.stopped_on_nan and result.last_epoch == 1
    final = weights.load_params_npz(tmp_path / "dm_eeg_no-spectral_edfx" / "final_model"
                                    / "params.npz")
    assert all(np.isfinite(v).all() for v in jax.tree_util.tree_leaves(final))


def test_sample_dm_cli_matches_jax_ddim_and_keeps_the_table_quirk(dm_run, monkeypatch):
    """``sample-dm`` on the train-dm run dir: artifacts as the JAX CLI
    writes them, held to JAX's DDIM over its schedule on the same weights
    and x_T; ``--num_ddim_steps`` is clamped to the table length
    ``--num_inference_steps``, and a shorter table is another trajectory."""
    root, result = dm_run
    base = ["sample-dm", "--diffusion_path", result.run_dir, "--start_seed", "0",
            "--stop_seed", "2", "--batch_size", "2", "--device", "cpu"]
    _umbrella(monkeypatch, *base, "--output_dir", str(root / "a"), "--num_inference_steps", "8")
    _umbrella(monkeypatch, *base, "--output_dir", str(root / "b"), "--num_inference_steps", "8",
              "--num_ddim_steps", "8", "--no_psd")
    _umbrella(monkeypatch, *base, "--output_dir", str(root / "c"), "--num_inference_steps", "16",
              "--num_ddim_steps", "8", "--no_psd")
    out = {k: root / k / "samples_ddpm_no-spectral_edfx" for k in "abc"}
    got = {k: np.stack([np.load(d / f"sample_{i}.npy") for i in range(2)]) for k, d in out.items()}
    assert got["a"].shape == (2, 1, 1, 3000)
    assert (out["a"] / "psd_list_1.npy").exists() and not (out["b"] / "psd_list_1.npy").exists()
    np.testing.assert_array_equal(got["a"], got["b"])  # 200 steps clamped to the table's 8
    assert np.abs(got["b"] - got["c"]).max() > 1e-3

    cfg, state = sample_ldm.read_model_dir(result.run_dir, "best_model")
    jm = JaxUNet(num_groups=8, **{**UNET_KW, "model_channels": 16})
    params = jax.tree_util.tree_map(jnp.asarray, weights.unet_state_to_jax(state))
    from sleepgen.cli.sample_trials_ddpm import dm_sampling_schedule as jax_schedule
    from sleepgen.config import Config as JaxConfig

    x_T = samplers.seed_noise(range(2), (3072, 1), "cpu").numpy()
    want = jax_samplers.ddim_sample_loop(lambda x, t: jm.apply({"params": params}, x, t),
                                         jax_schedule(JaxConfig(), 8), jnp.asarray(x_T), 8)
    want = np.asarray(want)[:, 36:-36, 0]
    np.testing.assert_allclose(got["a"][:, 0, 0], want, rtol=RTOL, atol=ATOL)


def test_sample_dm_cli_stage_rules(tmp_path, monkeypatch):
    """A conditional DM run dir: ``--stage`` required and in range, the
    stage-suffixed directory, and the guided artifact equal to
    ``sample_dm_trials``'s."""
    cfg = _dm_config(N_CLASSES)
    with torch.device("meta"):
        unet = sample_ldm.build_unet(cfg, 1, 1)
    cfg.to_yaml(tmp_path / "config.yaml")
    state = weights.seeded_state_dict(unet, 3)
    weights.save_params_npz(tmp_path / "params.npz", {"params": weights.unet_state_to_jax(state)})
    base = ["sample-dm", "--diffusion_path", str(tmp_path), "--output_dir", str(tmp_path / "o"),
            "--stop_seed", "2", "--batch_size", "2", "--num_inference_steps", "8", "--no_psd",
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="pass stage=0..4"):
        _umbrella(monkeypatch, *base)
    with pytest.raises(SystemExit, match="stage 5 out of range"):
        _umbrella(monkeypatch, *base, "--stage", "5")
    _umbrella(monkeypatch, *base, "--stage", "3", "--guidance_scale", "2.0")
    got = np.load(tmp_path / "o" / "samples_ddpm_no-spectral_edfx_stage3" / "sample_1.npy")
    want = sample_ldm.sample_dm_trials(cfg, state, tmp_path / "w", 0, 2, 2, 8, 200, False,
                                       "cpu", 3, 2.0)
    np.testing.assert_array_equal(got[0].T, want[1])
