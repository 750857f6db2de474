"""The port's decoder training against the JAX package's, on the CPU, for
the ``decode`` CLI's variant a (the 3-window Chambon stager) and b (the
single-window one; c, DeepSleepNet, runs the same tests from
test_torch_port_deepsleepnet_train.py, whose JAX compile is the slow
part) at their published widths, fp32, from the same numpy-drawn weights
and BatchNorm statistics (test_torch_port_decode's ``decoder_pair``).

Dropout is off on both sides: rate 0 in the port, and flax's
``nn.Dropout`` replaced by the identity on the JAX side (a monkeypatch
local to these tests), since torch cannot reproduce JAX's masks. The JAX
trainer's initial weights are set by replacing its ``jit_init``, the
port's by replacing its ``flax_init_state``.

Bounds (those of the card-against-CPU holds of ``chip_smoke.py``):
losses rtol 1e-5; every gradient leaf within 2e-3 of its largest |g|,
plus 1e-6 of the model's largest |g|, the rounding floor of a gradient
that is zero in exact arithmetic (a convolution's bias before a
BatchNorm in training mode, whose gradient is rounding noise near 1e-7
of the largest); BatchNorm running statistics rtol / atol 1e-5; what the
steps changed in each parameter within 1e-2 of the leaf's largest
change, leaving out entries whose gradient in some step is below 1e-3 of
its leaf's largest and leaves whose gradient is below 1e-5 of the model's
largest, as Adam's update takes the sign of such a gradient from a
rounding.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.train import decode as jax_decode
from sleepgen_torch.data.staging import balanced_class_weights
from sleepgen_torch.train import decode

from test_torch_port_decode import DECODERS, decoder_pair, to_bct

KINDS = ["sequence", "chambon"]  # the CLI's variants a and b; c: deepsleepnet_train
B = 8  # a multiple of the JAX tests' 8 CPU devices: the JAX trainer pads no batch
# Adam moves every weight by about lr sign(g), and a weight whose gradient
# is near 0 takes its sign from a rounding: at the trainer's lr 1e-3 the
# few such weights move the next loss by about 1e-5 of itself; at 1e-4
# they do not (as chip_smoke.py's tiny stage-1 trainer steps at 1e-4)
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _NoDropout(flax.linen.Module):
    rate: float = 0.0
    deterministic: bool | None = None

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)


def _batch(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, *DECODERS[kind][3])).astype(np.float32)
    return x, np.array([0, 1, 2, 3, 4, 0, 2, 2])


def _numpy(state) -> dict:
    return {k: v.detach().numpy().copy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in state.items()}


def _hold_gradients(got: dict, want: dict) -> None:
    top_all = max(float(np.abs(w).max()) for w in want.values())
    faults = []
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        if not err <= 2e-3 * float(np.abs(w).max()) + 1e-6 * top_all:
            faults.append(f"{k}: |err| {err:.3e}, leaf's largest {np.abs(w).max():.3e}")
    assert not faults, "\n".join(faults)


def _hold_stats(got: dict, want: dict) -> None:
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_matches_jax(kind, no_jax_dropout):
    """One training step from the same weights on the same batch: the
    loss, every gradient (the JAX step's loss_fn, differentiated by JAX)
    and the BatchNorm statistics it moved."""
    jm, v, pm = decoder_pair(kind, seed=20, dropout=0.0)
    bridge = DECODERS[kind][2]
    x, y = _batch(kind, 21)
    class_w = balanced_class_weights(y)

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": v.get("batch_stats", {})},
                            jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                            mutable=["batch_stats"])
        return (jax_decode.weighted_cross_entropy(out, jnp.asarray(y), jnp.asarray(class_w)),
                mut.get("batch_stats", {}))

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    want = _numpy(bridge({"params": jax.device_get(grads),
                          "batch_stats": jax.device_get(stats)}))

    opt, sched = decode.make_optimizer(pm, 1e-3, 1e-3, 3, B, B)
    got_loss = decode.make_train_step(pm, opt, sched, torch.from_numpy(class_w))(
        to_bct(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    params = dict(pm.named_parameters())
    _hold_gradients({k: p.grad.numpy() for k, p in params.items() if p.requires_grad},
                    {k: w for k, w in want.items() if k in params and params[k].requires_grad})
    _hold_stats(_numpy(pm.state_dict()), want)


def _jax_batch_stats(result) -> dict:
    """The final BatchNorm statistics of a JAX train_decoder run, which its
    ``predict`` closure holds."""
    cells = dict(zip(result.predict.__code__.co_freevars, result.predict.__closure__))
    return jax.device_get(cells["batch_stats"].cell_contents)


def _noise_leaves(grads: list, top_all: float) -> set:
    """Leaves whose gradient is rounding noise (below 1e-5 of the model's
    largest |g|): a convolution's bias before a BatchNorm."""
    return {k for k in grads[0] if max(float(np.abs(g[k]).max()) for g in grads) < 1e-5 * top_all}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_epochs", [1, 3])
def test_train_decoder_matches_jax(kind, n_epochs, no_jax_dropout, monkeypatch):
    """``train_decoder`` for ``n_epochs`` epochs of one step each (lr
    ``LR``, then half, then 0 by optax's cosine schedule): each epoch's
    loss (after zero, one and two updates), balanced accuracies and the
    confusion matrix; the final BatchNorm statistics.

    One step: what the update changed in every parameter (1e-2 of the
    leaf's largest change, entries of gradient below 1e-3 of the leaf's
    largest and noise leaves left out) and the statistics to 1e-5. Three
    steps: the running variances to 1e-5, and the running means also
    within what the noise-driven biases before them moved the batch means
    between the two (|db| <= 2 lr per update, momentum 0.1:
    0.48 LR after two updates); the parameters are not held after two
    Adam updates, whose second update divides by a moment sum that can
    cancel, so the step's own gradient tolerance shows up amplified (the
    updates are held in test_adamw_schedule_matches_optax, the gradients
    in test_train_step_matches_jax)."""
    jm, v, pm = decoder_pair(kind, seed=30, dropout=0.0)
    bridge = DECODERS[kind][2]
    x, y = _batch(kind, 31)
    xv, yv = _batch(kind, 32)
    before = _numpy(pm.state_dict())

    monkeypatch.setattr(jax_decode, "jit_init", lambda *a, **kw: v)
    want = jax_decode.train_decoder(jm, (x, y), (xv, yv), n_epochs=n_epochs, batch_size=B,
                                    lr=LR, seed=4)
    want_state = _numpy(bridge({"params": jax.device_get(want.params),
                                "batch_stats": _jax_batch_stats(want)}))

    grads = []
    make_step = decode.make_train_step

    def recording(model, *args, **kw):
        step = make_step(model, *args, **kw)

        def run(xb, yb):
            loss = step(xb, yb)
            grads.append({k: p.grad.numpy().copy() for k, p in model.named_parameters()
                          if p.grad is not None})
            return loss
        return run

    monkeypatch.setattr(decode, "make_train_step", recording)
    monkeypatch.setattr(decode, "flax_init_state", lambda *a: before)
    got = decode.train_decoder(pm, (x, y), (xv, yv), n_epochs=n_epochs, batch_size=B, lr=LR,
                               seed=4, device="cpu")
    got_state = _numpy(got.params)

    assert len(grads) == len(got.history) == len(want.history) == n_epochs
    for g, w in zip(got.history, want.history):
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        assert (g["train_bal_acc"], g["valid_bal_acc"]) == (w["train_bal_acc"],
                                                             w["valid_bal_acc"])
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.best_valid_bal_acc == want.best_valid_bal_acc
    np.testing.assert_array_equal(got.predict(xv), want.predict(xv))

    top_all = max(float(np.abs(g).max()) for step in grads for g in step.values())
    noise = _noise_leaves(grads, top_all)
    for k in want_state:
        if k.endswith("running_var") or (n_epochs == 1 and k.endswith("running_mean")):
            np.testing.assert_allclose(got_state[k], want_state[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(got_state[k], want_state[k], rtol=1e-5,
                                       atol=1e-5 + 0.48 * LR, err_msg=k)
    if n_epochs > 1:
        return
    faults = []
    for k in sorted(set(grads[0]) - noise):
        change, mine = want_state[k] - before[k], got_state[k] - before[k]
        keep = np.abs(grads[0][k]) >= 1e-3 * np.abs(grads[0][k]).max()
        top = float(np.abs(change).max())
        err = float(np.abs(mine - change)[keep].max(initial=0.0))
        if not (top > 0 and err <= 1e-2 * top):
            faults.append(f"change of {k}: |err| {err:.3e}, leaf's largest change {top:.3e}")
    assert not faults, "\n".join(faults)


def test_adamw_schedule_matches_optax():
    """The port's AdamW and cosine LambdaLR against optax's adamw over the
    cosine_decay_schedule, on the same parameters and the same gradients:
    two epochs of 70 windows at batch 16 (5 steps an epoch, the last
    partial; the decay over 4 steps, then lr 0), every parameter after
    every step within fp32 rounding (rtol 1e-6, atol 1e-7)."""
    import optax

    rng = np.random.default_rng(5)
    init = {"w": rng.standard_normal((6, 4)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(4)).astype(np.float32)}
    n, b, n_epochs = 70, 16, 2
    steps = n_epochs * -(-n // b)
    grads = [{k: (rng.standard_normal(a.shape) * 10.0 ** rng.integers(-4, 1, a.shape)
                  ).astype(np.float32) for k, a in init.items()} for _ in range(steps)]

    opt = optax.adamw(optax.cosine_decay_schedule(1e-3, max(1, (n_epochs - 1) * (n // b))),
                      weight_decay=1e-3)
    params = {k: jnp.asarray(a) for k, a in init.items()}
    state = opt.init(params)
    model = torch.nn.Module()
    for k, a in init.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(a.copy())))
    topt, sched = decode.make_optimizer(model, 1e-3, 1e-3, n_epochs, n, b)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(a) for k, a in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        sched.step()
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
