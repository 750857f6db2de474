"""The port's downstream sleep-stage decoding against the JAX package, on
the CPU: the staging functions, the synthetic staged recordings, the
decoders' convolutions and forwards, their state dicts in braindecode's
names, the learning-rate schedule, the loss and metrics, and the
``decode`` CLI's data and artifacts. ``test_torch_port_decode_train.py``
holds the training steps.

The decoders are at their published widths (Chambon: 8 filters, k 50,
pool 13; DeepSleepNet: 64 / 128 channels, BiLSTM 512 per direction) on
30 s windows at 100 Hz, a few windows a batch, fp32. Every weight leaf is
drawn from numpy (test_torch_port_parity's ``_randomize``) and every
BatchNorm's running mean from N(0, 0.1^2) and variance from U(0.5, 1.5),
so no BatchNorm is the identity; the port's modules load them through
``sleepgen_torch.utils.weights`` with ``strict=True``. Bounds: integers
bit for bit, staging floats 1e-6, a convolution alone rtol 1e-5 / atol
1e-5 (strided SAME 2e-5, the JAX package's own bounds for
``Im2ColConv1d``), a whole decoder the model bound of
tests/test_torch_import.py (rtol 2e-3 / atol 2e-4).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from sleepgen.data import staging as jax_staging
from sleepgen.nn.chambon import Im2ColConv1d
from sleepgen.nn.chambon import SleepStagerChambon2018 as JaxChambon
from sleepgen.nn.chambon import TimeDistributedStager as JaxSequence
from sleepgen.nn.deepsleepnet import DeepSleepNet as JaxDeepSleepNet
from sleepgen.nn.layers import conv1d as jax_conv1d
from sleepgen.train import decode as jax_decode
from sleepgen.utils import jit_init
from sleepgen.utils.torch_import import import_chambon, import_chambon_sequence
from sleepgen_torch.cli import run_sleep_decode
from sleepgen_torch.data import staging
from sleepgen_torch.nn.chambon import SleepStagerChambon2018, TimeDistributedStager
from sleepgen_torch.nn.deepsleepnet import DeepSleepNet
from sleepgen_torch.nn.discriminator import SameConv1d
from sleepgen_torch.train import decode
from sleepgen_torch.utils import weights

from test_torch_port_parity import _randomize

RTOL, ATOL = 2e-3, 2e-4
CONFIG_DIR = Path(__file__).resolve().parent.parent / "sleepgen" / "configs"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: the suite runs several
    worker processes on the same cores, where each process's spinning
    thread pool slows every small op of the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the decoders, JAX and port ------------------------------------------------

# kind: (JAX module, port module, state bridge, input (T, C) or (S, T, C) of one item)
DECODERS = {
    "chambon": (lambda: JaxChambon(n_chans=1, sfreq=100, dropout=0.5),
                lambda: SleepStagerChambon2018(dropout=0.5),
                weights.chambon_state_from_jax, (3000, 1)),
    "chambon_2ch_bn": (lambda: JaxChambon(n_chans=2, sfreq=100, apply_batch_norm=True,
                                          pad_size_s=0.1),
                       lambda: SleepStagerChambon2018(n_chans=2, apply_batch_norm=True,
                                                      pad_size_s=0.1),
                       weights.chambon_state_from_jax, (3000, 2)),
    "sequence": (lambda: JaxSequence(n_chans=1, sfreq=100), TimeDistributedStager,
                 weights.chambon_sequence_state_from_jax, (3, 3000, 1)),
    "deepsleepnet": (lambda: JaxDeepSleepNet(n_outputs=5, sfreq=100), DeepSleepNet,
                     weights.deepsleepnet_state_from_jax, (3000, 1)),
}


def random_stats(tree, seed):
    """Running means N(0, 0.1^2), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if "mean" in jax.tree_util.keystr(path[-1:]):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def decoder_pair(kind: str, seed: int, dropout: float | None = None):
    """(JAX module, its variables with numpy-drawn weights and statistics,
    the port module holding the same ones, in train mode, its dropout
    rate set to ``dropout`` if given)."""
    make_jax, make_port, bridge, item = DECODERS[kind]
    jm = make_jax()
    v = jit_init(jm, {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                 jnp.zeros((2, *item)), train=False)
    variables = {"params": _randomize(v["params"], seed)}
    if "batch_stats" in v:
        variables["batch_stats"] = random_stats(v["batch_stats"], seed + 1)
    pm = weights.load_numpy_state(make_port(), bridge(variables))
    if dropout is not None:
        pm.p_dropout = dropout
    return jm, variables, pm


def to_bct(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, -1, -2)))


@pytest.fixture(scope="module")
def pairs():
    return {kind: decoder_pair(kind, seed) for seed, kind in enumerate(DECODERS)}


# -- staging --------------------------------------------------------------------

def _annotations():
    return [(0.0, 30.0, "Sleep stage W"), (30.0, 90.0, "Sleep stage 2"),
            (120.0, 30.0, "Movement time"), (150.0, 20.0, "Sleep stage 4"),
            (170.0, 30.0, "Sleep stage R"), (195.0, 60.0, "Sleep stage 1")]


STAGING_CASES = {
    "windows_2ch": lambda m, sig: m.windows_from_annotations(sig, 100, _annotations()),
    "windows_offset": lambda m, sig: m.windows_from_annotations(sig, 100, _annotations(),
                                                                t_offset=12.5),
    "windows_1d": lambda m, sig: m.windows_from_annotations(sig[:, 0], 100, _annotations()),
    "windows_none": lambda m, sig: m.windows_from_annotations(
        sig, 100, [(0.0, 30.0, "Sleep stage ?")]),
    "standard_scale": lambda m, sig: m.standard_scale_windows(np.concatenate(
        [sig[None, :3000], np.ones((1, 3000, 2))]).astype(np.float32)),
    "sequence_stride_3": lambda m, sig: m.sequence_indices(
        np.array([0] * 7 + [1] * 4 + [2] * 2), 3, 3),
    "sequence_stride_1": lambda m, sig: m.sequence_indices(np.array([3] * 5 + [1] * 4), 3, 1),
    "center_label": lambda m, sig: m.center_label(
        np.arange(11) * 2, m.sequence_indices(np.array([0] * 7 + [1] * 4), 3, 3)),
    "balanced_weights": lambda m, sig: m.balanced_class_weights(np.array([0, 0, 0, 1, 4, 4])),
}


@pytest.mark.parametrize("case", sorted(STAGING_CASES))
def test_staging_matches_jax(case):
    """Integers bit for bit (dtype included), floats within 1e-6."""
    sig = np.random.default_rng(0).normal(size=(24000, 2)) * 40.0
    got, want = STAGING_CASES[case](staging, sig), STAGING_CASES[case](jax_staging, sig)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_stage_tables_match_jax():
    assert staging.STAGE_MAPPING == jax_staging.STAGE_MAPPING
    assert staging.STAGE_NAMES == jax_staging.STAGE_NAMES
    np.testing.assert_array_equal(staging._STAGE_TRANSITIONS, jax_staging._STAGE_TRANSITIONS)
    assert staging._CONFUSABLE == jax_staging._CONFUSABLE


def test_make_synthetic_staged_matches_jax():
    got = staging.make_synthetic_staged(3, 6, seed=5)
    want = jax_staging.make_synthetic_staged(3, 6, seed=5)
    assert got[0].shape == want[0].shape == (18, 3000, 1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


# -- convolutions -------------------------------------------------------------------

def test_chambon_conv_matches_im2col():
    """Chambon's VALID-padded convolution (k 50, padding (10, 10), one
    input channel): the port's Conv2d (F, 1, 1, k) against
    ``Im2ColConv1d`` with the same kernel."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 301, 1)).astype(np.float32)
    m = Im2ColConv1d(8, 50, padding=(10, 10))
    v = jit_init(m, jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(m.apply(v, jnp.asarray(x)))
    conv = nn.Conv2d(1, 8, (1, 50), padding=(0, 10))
    kernel = np.array(v["params"]["kernel"])  # (k, in, F) -> (F, in, 1, k)
    conv.weight.data = torch.from_numpy(kernel.transpose(2, 1, 0)[:, :, None, :].copy())
    conv.bias.data = torch.from_numpy(np.array(v["params"]["bias"]))
    with torch.no_grad():
        got = conv(to_bct(x)[:, None])[:, :, 0].numpy()  # (B, F, T')
    np.testing.assert_allclose(got.transpose(0, 2, 1), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,s,t", [(50, 6, 3000), (400, 50, 3000), (7, 3, 29), (8, 1, 63)])
def test_strided_same_conv_matches_im2col(k, s, t):
    """DeepSleepNet's SAME convolutions (TF-style padding, the odd element
    on the right): the port's SameConv1d against ``Im2ColConv1d(padding=
    "SAME")`` and flax's own conv at stride ``s``."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, t, 1)).astype(np.float32)
    m = Im2ColConv1d(16, k, stride=s, padding="SAME", use_bias=False)
    v = jit_init(m, jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(m.apply(v, jnp.asarray(x)))
    flax_conv = jax_conv1d(16, k, stride=s, use_bias=False)
    np.testing.assert_allclose(np.asarray(flax_conv.apply(v, jnp.asarray(x))), want,
                               rtol=2e-5, atol=2e-5)
    conv = SameConv1d(1, 16, k, stride=s, bias=False)
    conv.weight.data = torch.from_numpy(np.array(v["params"]["kernel"]).transpose(2, 1, 0).copy())
    with torch.no_grad():
        got = conv(to_bct(x)).numpy()
    assert got.shape == (2, 16, -(-t // s))
    np.testing.assert_allclose(got.transpose(0, 2, 1), want, rtol=2e-5, atol=2e-5)


# -- the decoders -----------------------------------------------------------------

@pytest.mark.parametrize("kind,seq", [("chambon", 0), ("chambon_2ch_bn", 0), ("sequence", 0),
                                      ("deepsleepnet", 0), ("deepsleepnet", 3)],
                         ids=["chambon", "chambon_2ch_bn", "sequence", "deepsleepnet",
                              "deepsleepnet_sequence"])
def test_decoder_forward_matches_jax(pairs, kind, seq):
    """Eval mode (running statistics, no dropout) at the model bound.
    DeepSleepNet also in sequence mode, (B, 3, T, C) -> (B, 3, 5)."""
    jm, v, pm = pairs[kind]
    item = DECODERS[kind][3]
    shape = (3, seq, *item) if seq else (3, *item)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda v_, a: jm.apply(v_, a, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.eval()(to_bct(x)).numpy()
    assert got.shape == want.shape == ((3, seq, 5) if seq else (3, 5))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["chambon", "chambon_2ch_bn", "sequence"])
def test_chambon_state_round_trips_through_the_reference_importer(pairs, kind):
    """The port's state dict is in braindecode's names: the JAX package's
    importer of the reference's decode checkpoints gives back the JAX
    variables exactly (``num_batches_tracked`` aside)."""
    _, v, pm = pairs[kind]
    importer = import_chambon_sequence if kind == "sequence" else import_chambon
    back = importer(pm.state_dict())
    flat = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(v)}
    flat_back = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat) == set(flat_back)
    for k, a in flat.items():
        np.testing.assert_array_equal(flat_back[k], a, err_msg=k)
    names = set(pm.state_dict())
    assert "final_layer.1.weight" in names or "1.2.weight" in names


def test_deepsleepnet_lstm_bias_is_held_at_zero():
    """flax's cell has one bias per gate: torch's input bias is zero and
    takes no gradient, so no optimiser moves it."""
    m = DeepSleepNet()
    for lstm in (m.lstm_0, m.lstm_1):
        for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
            bias = getattr(lstm, name)
            assert not bias.requires_grad and not bias.any()
    opt, _ = decode.make_optimizer(m, 1e-3, 1e-3, 2, 64, 8)
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(m.lstm_0.bias_ih_l0) not in trained and id(m.lstm_0.bias_hh_l0) in trained


# -- schedule, loss, metrics -----------------------------------------------------

@pytest.mark.parametrize("n_epochs", [1, 2, 10])
def test_lr_schedule_matches_optax(n_epochs):
    """70 windows at batch 16: 5 steps an epoch (the last partial), decay
    over (n_epochs - 1) * 4 steps, then 0. The optimiser's own rate at
    every step equals optax's schedule to its fp32 rounding (rtol 1e-5)."""
    n, b = 70, 16
    sched = optax.cosine_decay_schedule(1e-3, max(1, (n_epochs - 1) * (n // b)))
    model = nn.Linear(2, 2)
    opt, lr_sched = decode.make_optimizer(model, 1e-3, 1e-3, n_epochs, n, b)
    f = decode.cosine_decay(1e-3, n_epochs, n, b)
    for t in range(n_epochs * -(-n // b) + 2):
        want = float(sched(t))
        np.testing.assert_allclose(f(t), want, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want, rtol=1e-5, atol=1e-12)
        model(torch.ones(1, 2)).sum().backward()
        opt.step()
        lr_sched.step()


def test_loss_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((32, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 32)
    w = np.array([0.5, 2.0, 0.0, 1.0, 1.5], np.float32)
    want = float(jax_decode.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                   jnp.asarray(w)))
    got = float(decode.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                              torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    y_true = np.array([0, 0, 1, 1, 1, 3, 3, 4])
    y_pred = np.array([0, 1, 1, 1, 2, 3, 0, 4])
    assert decode.balanced_accuracy(y_true, y_pred) == jax_decode.balanced_accuracy(y_true, y_pred)
    np.testing.assert_array_equal(decode.confusion_matrix(y_true, y_pred),
                                  jax_decode.confusion_matrix(y_true, y_pred))
    assert decode.balanced_accuracy(np.array([], int), np.array([], int)) == 0.0


# -- the decode CLI ---------------------------------------------------------------

def write_ingest_tree(root: Path, n_recordings: int = 6, seed: int = 1) -> Path:
    """convert-edfx's outputs for ``n_recordings`` of 150 s: <rec>-Fpz-Cz.npy
    (1, T) in volts and <rec>-annotation.npy, one of them without signal."""
    data = root / "npy"
    data.mkdir()
    rng = np.random.default_rng(seed)
    t = np.arange(150 * 100) / 100.0
    stages = ["Sleep stage W", "Sleep stage 1", "Sleep stage 2", "Sleep stage 3",
              "Sleep stage R"]
    for s in range(n_recordings):
        order = rng.permutation(5)
        anns = [(30.0 * i, 30.0, stages[k]) for i, k in enumerate(order)]
        sig = 30e-6 * np.sin(2 * np.pi * (1 + s) * t) + 8e-6 * rng.standard_normal(len(t))
        np.save(data / f"SC4{s:02d}0E0-Fpz-Cz.npy", sig[None, :])
        np.save(data / f"SC4{s:02d}0E0-annotation.npy", np.array(anns, dtype=object),
                allow_pickle=True)
    np.save(data / "SC4990E0-annotation.npy", np.array(anns, dtype=object), allow_pickle=True)
    return data


@pytest.fixture(scope="module")
def ingest_tree(tmp_path_factory):
    return write_ingest_tree(tmp_path_factory.mktemp("decode"))


def test_load_staged_dataset_matches_jax(ingest_tree):
    from sleepgen.cli.run_sleep_decode import load_staged_dataset as jax_load

    got = run_sleep_decode.load_staged_dataset(ingest_tree, "Fpz-Cz")
    want = jax_load(ingest_tree, "Fpz-Cz")
    assert got[0].shape == want[0].shape == (30, 3000, 1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_decode_cli_trains_on_the_jax_split(ingest_tree, monkeypatch, tmp_path, variant):
    """Each variant hands its trainer the JAX CLI's train and valid arrays
    (the RandomState(42) split by recording, 3-window sequences for a),
    the JAX CLI's decoder (its type and dropout), epochs, batch and seed."""
    import sleepgen.train.decode as jax_trainer
    from sleepgen.cli.run_sleep_decode import main as jax_main

    seen = {}

    def capture(tag):
        def fake(model, train_xy, valid_xy, n_epochs, batch_size, seed, **kw):
            seen[tag] = (model, train_xy, valid_xy, n_epochs, batch_size, seed)
            raise _Captured
        return fake

    monkeypatch.setattr(jax_trainer, "train_decoder", capture("jax"))
    monkeypatch.setattr(run_sleep_decode, "train_decoder", capture("port"))
    argv = ["--data_dir", str(ingest_tree), "--variant", variant, "--n_epochs", "3",
            "--batch_size", "4", "--output_dir", str(tmp_path),
            "--config_file", str(CONFIG_DIR / "sleep_stage.yaml")]
    for tag, main in (("jax", jax_main), ("port", run_sleep_decode.main)):
        with pytest.raises(_Captured):
            main(argv + (["--device", "cpu"] if tag == "port" else []))
    (jm, jtr, jva, *jrest), (pm, ptr, pva, *prest) = seen["jax"], seen["port"]
    assert prest == jrest
    assert type(pm).__name__ == type(jm).__name__
    if variant != "c":
        assert pm.p_dropout == (jm.dropout if variant == "b" else jm.head_dropout) == 0.5
    for got, want in ((ptr, jtr), (pva, jva)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert len(ptr[0]) > len(pva[0]) > 0


@pytest.mark.parametrize("variant,config", [("a", "sleep_stage.yaml"), ("b", "sleep_stage_b.yaml"),
                                            ("c", "sleep_stage_c.yaml")])
def test_decode_cli_writes_the_artifacts(ingest_tree, tmp_path, variant, config):
    """``decode --device cpu``: history.json with the JAX CLI's keys, one
    entry per epoch, and confusion_matrix.npy (5, 5) over the valid set,
    under the config's run dir."""
    from sleepgen_torch.__main__ import COMMANDS
    from sleepgen_torch.config import Config

    assert COMMANDS["decode"] == "sleepgen_torch.cli.run_sleep_decode"
    res = run_sleep_decode.main(["--data_dir", str(ingest_tree), "--variant", variant,
                                 "--n_epochs", "2", "--batch_size", "8", "--output_dir",
                                 str(tmp_path), "--config_file", str(CONFIG_DIR / config),
                                 "--device", "cpu"])
    out = tmp_path / Config.from_yaml(CONFIG_DIR / config).train.run_dir
    hist = json.loads((out / "history.json").read_text())
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(set(h) == {"epoch", "loss", "train_bal_acc", "valid_bal_acc"} for h in hist)
    assert all(np.isfinite(h["loss"]) and 0.0 <= h["valid_bal_acc"] <= 1.0 for h in hist)
    cm = np.load(out / "confusion_matrix.npy")
    n_valid = 1 if variant == "a" else 5  # one recording of 5 windows
    assert cm.shape == (5, 5) and cm.dtype == np.int64 and cm.sum() == n_valid
    np.testing.assert_array_equal(cm, res.confusion)
    assert res.best_valid_bal_acc == max(h["valid_bal_acc"] for h in hist)
