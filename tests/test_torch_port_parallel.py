"""Data parallelism over ``torch.distributed`` (``sleepgen_torch.parallel``):
the result must not depend on the world size.

Two gloo processes (spawned as ``tests/test_multihost.py`` spawns its
workers: a free port, a timeout per process) run each case with a mesh of
two; this process runs the same cases without one. Cases, at tiny widths
(UNet model_channels 16, channel_mult (1, 2), attention at ds 2, G 8;
AEKL [2, 2, 4], latent 1; windows of 256): two stage-2 steps at batch 8,
one ``train_ldm`` epoch on six recordings at batch 4 (its last batch is
padded), one stage-1 step with the discriminator's BatchNorm on the global
batch, two DeepSleepNet ``decode`` steps at batch 4 (dropout masks of the
global batch), and a 4-step DDIM sampler over 16 seeds. Bounds are
``tests/test_parallel.py``'s: losses rtol 1e-5, parameters rtol 1e-4 /
atol 1e-6, samples rtol 1e-6 / atol 1e-6; both ranks hold identical
parameters. The two-process stage-2 step is also held to JAX's step on a
two-device CPU mesh, fed JAX's own draws, at the model bound of
tests/test_torch_import.py (rtol 2e-3 / atol 2e-4).

What the bounds meet, and why. This CPU build's convolutions sum in an
order that depends on the batch: a seeded UNet's forward at batch 8 and
at batch 16 differs by up to 9e-7. So no step or window is bitwise the
same over one rank and over two, and Adam's first step, which moves each
parameter by about its rate whatever the size of its gradient, turns a
rounding-level gradient (a cancellation) into a step of random sign. The
stage-2 step and the sampler are therefore held at JAX's bounds from the
weights the trainers start from (``init_unet_state``: zero output
convolutions, as JAX's test starts from ``jit_init``), and with seeded
weights in every layer at stated bounds: the step's averaged gradients
within 1e-5 of each leaf's largest (measured 2e-6), the windows within
1e-5 (measured 2.7e-6). The decoder's two steps use SGD at the decode
CLI's rate, so the parameters show the gradients' agreement at JAX's
bounds; the decode trainer's AdamW is applied to the same averaged
gradient on every rank, and is held to optax in
``tests/test_torch_port_decode_train.py``.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sleepgen_torch.parallel import (Mesh, make_mesh, pad_to_multiple, prefetch_to_device,
                                     shard_batch, split_seeds)

HERE = Path(__file__).resolve()
WINDOW, BATCH = 256, 8
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL, SAMPLE_TOL = 1e-5, 1e-4, 1e-6, 1e-6
SEEDED_GRAD_TOL, SEEDED_SAMPLE_TOL = 1e-5, 1e-5  # module docstring


def _cfg():
    from sleepgen_torch.config import Config

    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = [2, 2, 4]
    cfg.aekl.latent_channels = 1
    cfg.unet.model_channels = 16
    cfg.unet.norm_num_groups = 8
    cfg.unet.channel_mult = [1, 2]
    cfg.unet.attention_resolutions = [2]
    cfg.unet.image_size = WINDOW // 4
    cfg.discriminator.num_channels = 8
    return cfg


def _ldm_models(cfg, trainer_init=False):
    """The tiny UNet and AEKL with seeded weights in every layer, or the
    UNet with the stage-2 trainer's initial weights."""
    from sleepgen_torch.sample.sample_ldm import build_aekl, build_unet
    from sleepgen_torch.train.train_ldm import init_unet_state
    from sleepgen_torch.utils import weights

    unet, ae = build_unet(cfg, 1, 1), build_aekl(cfg)
    weights.load_numpy_state(unet, init_unet_state(unet, 3) if trainer_init
                             else weights.seeded_state_dict(unet, 3))
    weights.load_numpy_state(ae, weights.seeded_state_dict(ae, 4))
    return unet, ae.requires_grad_(False)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _ldm_steps(mesh, cfg, draws=None, n_steps=2, trainer_init=True):
    """Stage-2 Adam steps on the global batch (seeded), each rank on its
    shard; ``draws`` (x, t, noise, enc_eps) replace the seeded ones. With
    seeded weights (``trainer_init`` False) the step's optimizer is SGD at
    rate 0, and the gradients are returned."""
    from sleepgen_torch.train.train_ldm import draw_step_inputs, make_ldm_train_step, make_schedule

    unet, ae = _ldm_models(cfg, trainer_init)
    opt = (torch.optim.Adam(unet.parameters(), lr=1e-4) if trainer_init
           else torch.optim.SGD(unet.parameters(), lr=0.0))
    step = make_ldm_train_step(unet, ae, make_schedule(cfg), opt, 1.0, mesh=mesh)
    shard = mesh.shard if mesh is not None else (lambda v: v)
    losses = []
    for i in range(n_steps):
        if draws is None:
            gen = torch.Generator().manual_seed(100 + i)
            x = torch.rand((BATCH, 1, WINDOW), generator=gen)
            t, noise, enc_eps = draw_step_inputs(gen, BATCH, (1, WINDOW // 4), 1000)
        else:
            x, t, noise, enc_eps = draws
        losses.append(step(*(shard(v) for v in (x, t, noise, enc_eps))))
    out = {"losses": torch.stack(losses), "params": _params(unet)}
    if not trainer_init:
        out["grads"] = {k: v.grad.clone() for k, v in unet.named_parameters()}
    return out


def _train_ldm(mesh, cfg, base):
    """One epoch of train_ldm, each rank in a run dir of its own; rank 0's
    final model (read by every rank after a barrier) and how many files
    this rank wrote."""
    from sleepgen_torch.data.dataset import WindowDataset
    from sleepgen_torch.data.synthetic import make_synthetic_dataset
    from sleepgen_torch.train.train_ldm import train_ldm
    from sleepgen_torch.utils import weights

    cfg.train.batch_size, cfg.train.n_epochs, cfg.train.val_interval = 4, 1, 1
    rank = mesh.rank if mesh is not None else 0
    cfg.train.output_dir = str(base / f"runs_{rank}")
    ds = WindowDataset.from_raw(make_synthetic_dataset(6, duration_s=40.0, seed=5),
                                window=WINDOW - 2 * 36)
    _, ae = _ldm_models(cfg)
    res = train_ldm(cfg, ds, ds, ae.state_dict(), device="cpu", mesh=mesh)
    if mesh is not None:
        torch.distributed.barrier()
    written = sum(p.is_file() for p in Path(res.run_dir).rglob("*"))
    run_dir = base / "runs_0" / Path(res.run_dir).name
    params = weights.load_params_npz(run_dir / "final_model" / "params.npz")
    return {"best_loss": torch.tensor(res.best_loss), "scale": torch.tensor(res.scale_factor),
            "written": written, "params": {k: torch.from_numpy(v) for k, v in
                                           weights.unet_state_from_jax(params).items()}}


def _stage1_step(mesh, cfg):
    from sleepgen_torch.train.train_aekl import build_trainer, make_train_step

    ae, disc, opt_g, opt_d = build_trainer(cfg, "cpu")
    step = make_train_step(ae, disc, opt_g, opt_d, cfg, mesh=mesh)
    gen = torch.Generator().manual_seed(7)
    x = torch.rand((BATCH, 1, WINDOW), generator=gen)
    eps = torch.randn((BATCH, 1, WINDOW // 4), generator=gen)
    shard = mesh.shard if mesh is not None else (lambda v: v)
    metrics = step(shard(x), shard(eps))
    return {"metrics": torch.stack([metrics[k] for k in sorted(metrics)]),
            "params": {**{f"g.{k}": v for k, v in _params(ae).items()},
                       **{f"d.{k}": v for k, v in _params(disc).items()}}}


def _decode_steps(mesh):
    from sleepgen_torch.nn.deepsleepnet import DeepSleepNet
    from sleepgen_torch.train.decode import cosine_decay, make_train_step
    from sleepgen_torch.utils.weights import flax_init_state, load_numpy_state

    model = DeepSleepNet()
    load_numpy_state(model, flax_init_state(model, 2))
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)  # module docstring
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(1.0, 2, 8, 4))
    step = make_train_step(model, opt, sched, torch.tensor([1.0, 2.0, 0.5, 1.0, 1.5]),
                           torch.Generator().manual_seed(11), mesh)
    shard = mesh.shard if mesh is not None else (lambda v: v)
    rng = np.random.default_rng(12)
    losses = []
    for _ in range(2):
        x = torch.from_numpy(rng.normal(size=(4, 1, 3000)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 5, 4))
        losses.append(step(shard(x), shard(y)))
    return {"losses": torch.stack(losses), "params": _params(model)}


def _sample(mesh, cfg):
    """The 16 seeds' windows from the trainer's initial UNet and from the
    seeded one."""
    from sleepgen_torch.sample.sample_ldm import make_ldm_sampler, sampling_schedule

    out = {}
    for name, init in (("samples", True), ("seeded", False)):
        unet, ae = _ldm_models(cfg, init)
        sampler = make_ldm_sampler(unet.eval(), ae.eval(), sampling_schedule(cfg),
                                   WINDOW // 4, 1, num_inference_steps=4, border_pad=4,
                                   device="cpu", mesh=mesh)
        out[name] = sampler(1.0, list(range(16)))
    return out


def run_cases(mesh, out_dir, jax_draws=None):
    """Every case of the module docstring, with ``mesh`` (None: one
    process, no mesh); ``jax_draws`` adds the step fed JAX's draws."""
    torch.manual_seed(0)
    cfg = _cfg()
    out = {"ldm": _ldm_steps(mesh, cfg), "ldm_seeded": _ldm_steps(mesh, cfg, n_steps=1,
                                                                  trainer_init=False),
           "train_ldm": _train_ldm(mesh, _cfg(), out_dir),
           "stage1": _stage1_step(mesh, cfg), "decode": _decode_steps(mesh),
           "sample": _sample(mesh, cfg)}
    if mesh is not None:  # each rank's own values in, rank 0's out
        from sleepgen_torch.parallel import replicate

        lin = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(lin.weight, float(mesh.rank + 1))
        state = {"w": torch.full((4,), float(mesh.rank + 1)), "step": 3}
        replicate(mesh, lin)
        replicate(mesh, state)
        out["replicate"] = {"linear": lin.weight.detach().clone(), "state": state["w"]}
    if jax_draws is not None:
        out["jax"] = _ldm_steps(mesh, cfg, [torch.from_numpy(jax_draws[k])
                                            for k in ("x", "t", "noise", "enc_eps")], 1,
                                trainer_init=False)
    return out


def _worker(rank: int, world: int, port: int, out: str, draws: str) -> None:
    import torch.distributed as dist

    from sleepgen_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.shape == {"data": world, "model": 1} and mesh.rank == rank
        with np.load(draws) as z:
            jax_draws = {k: z[k] for k in z.files}
        torch.save(run_cases(mesh, Path(out).parent, jax_draws), out)
    finally:
        dist.destroy_process_group()


# -- the test process ---------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: its models are tiny,
    and the suite runs several worker processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_step(tmp):
    """JAX's stage-2 step on a two-device CPU mesh from the port's seeded
    weights, with optax's SGD at rate 1 so the update is the gradient.
    Writes the draws it makes (its own split of the step key) to
    ``tmp/draws.npz`` first, then yields; the next ``next`` runs the step
    and returns its loss and its gradients as a port state dict."""
    import jax
    import jax.numpy as jnp
    import optax

    from sleepgen.config import Config as JaxConfig
    from sleepgen.parallel import make_mesh as jax_mesh
    from sleepgen.parallel import replicate, shard_batch as jax_shard
    from sleepgen.train.train_aekl import build_models
    from sleepgen.train.train_ldm import DiffusionState, build_unet
    from sleepgen.train.train_ldm import make_ldm_train_step as jax_make_step
    from sleepgen.train.train_ldm import make_schedule
    from sleepgen_torch.utils import weights

    unet, ae = _ldm_models(_cfg())
    uparams = weights.unet_state_to_jax(unet.state_dict())
    aparams = weights.aekl_state_to_jax(ae.state_dict())
    x = np.random.default_rng(9).random((BATCH, WINDOW, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(0)
    k_enc, k_t, k_noise, _ = jax.random.split(jax.random.fold_in(rng, 0), 4)
    draws = {"x": x, "enc_eps": jax.random.normal(k_enc, (BATCH, WINDOW // 4, 1)),
             "t": np.asarray(jax.random.randint(k_t, (BATCH,), 0, 1000)).astype(np.int64),
             "noise": jax.random.normal(k_noise, (BATCH, WINDOW // 4, 1))}
    np.savez(tmp / "draws.npz", **{k: np.asarray(v).transpose(0, 2, 1).copy()
                                   if np.ndim(v) == 3 else v for k, v in draws.items()})
    yield

    jcfg = JaxConfig()
    jcfg.dtype = "float32"
    jcfg.aekl.num_channels, jcfg.aekl.latent_channels = [2, 2, 4], 1
    jcfg.unet.model_channels, jcfg.unet.norm_num_groups = 16, 8
    jcfg.unet.channel_mult, jcfg.unet.attention_resolutions = [1, 2], [2]
    mesh = jax_mesh(devices=jax.devices()[:2])
    opt = optax.sgd(1.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, uparams)
    state = replicate(mesh, DiffusionState(
        step=jnp.zeros((), jnp.int32), params=jparams, opt=opt.init(jparams),
        best_loss=jnp.asarray(jnp.inf, jnp.float32),
        scale_factor=jnp.asarray(1.0, jnp.float32)))
    jae, _ = build_models(jcfg, jnp.float32)
    step = jax_make_step(build_unet(jcfg, 1, 1, jnp.float32), jae, replicate(mesh, aparams),
                         make_schedule(jcfg), opt)
    state, metrics = step(state, jax_shard(mesh, jnp.asarray(x)), rng)
    new = weights.unet_state_from_jax(jax.device_get(state.params))
    old = weights.unet_state_from_jax(uparams)
    yield float(metrics["loss"]), {k: old[k] - new[k] for k in old}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"two": each rank's ``run_cases`` over a gloo mesh of two, "one":
    ``run_cases`` without a mesh, "jax": JAX's step}. The ranks run while
    this process compiles JAX's step and runs its own cases."""
    tmp = tmp_path_factory.mktemp("ranks")
    jax_step = _jax_step(tmp)
    next(jax_step)
    port = _free_port()
    # one thread each for numpy's BLAS too (the decoders' orthogonal
    # initial weights): two ranks on a shared host oversubscribe it eightfold
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    repo = str(HERE.parents[1])
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    outs = [tmp / f"rank_{r}.pt" for r in range(2)]
    logs = [open(tmp / f"rank_{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(HERE), str(r), "2", str(port), str(outs[r]),
                               str(tmp / "draws.npz")], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        jax_result = next(jax_step)
        one = run_cases(None, tmp_path_factory.mktemp("one"))
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for f in logs:
        f.seek(0)
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(f.read() for f in logs)
    return {"two": [torch.load(o, weights_only=False) for o in outs], "one": one,
            "jax": jax_result}


@pytest.fixture(scope="module")
def two_ranks(runs):
    return runs["two"]


@pytest.fixture(scope="module")
def one_rank(runs):
    return runs["one"]


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol, err_msg=what)


def _same_params(ranks, one, case):
    p0, p1 = ranks[0][case]["params"], ranks[1][case]["params"]
    assert set(p0) == set(one[case]["params"])
    for k, v in one[case]["params"].items():
        assert torch.equal(p0[k], p1[k]), k  # the ranks hold identical parameters
        _close(p0[k].float(), v.float(), PARAM_RTOL, PARAM_ATOL, k)


def test_pad_to_multiple():
    x = np.arange(10).reshape(5, 2)
    y = pad_to_multiple(x, 4)
    assert y.shape == (8, 2)
    np.testing.assert_array_equal(y[5:], np.tile(x[-1:], (3, 1)))
    np.testing.assert_array_equal(pad_to_multiple(x, 5), x)


def test_shard_batch_and_seeds():
    """A rank keeps its contiguous rows (of each element of a labelled
    tuple); the world of one keeps them all."""
    batch = np.arange(16, dtype=np.float32).reshape(8, 2)
    labels = np.arange(8)
    mesh = Mesh(4, 2, torch.device("cpu"))
    x, y = shard_batch(mesh, (batch, labels))
    np.testing.assert_array_equal(x.numpy(), batch[4:6])
    np.testing.assert_array_equal(y.numpy(), labels[4:6])
    assert list(split_seeds(mesh, list(range(8)))) == [4, 5]
    with pytest.raises(ValueError):
        mesh.shard(torch.zeros(6))
    one = make_mesh(device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.group is None and one.is_main
    np.testing.assert_array_equal(shard_batch(one, batch).numpy(), batch)
    with pytest.raises(NotImplementedError):
        make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(n_data=2, device="cpu")


def test_prefetch_casts_only_x():
    mesh = Mesh(2, 1, torch.device("cpu"))
    batches = [(np.full((4, 3), i, np.float32), np.arange(4)) for i in range(5)]
    got = list(prefetch_to_device(iter(batches), mesh, size=2, dtype=torch.bfloat16))
    assert len(got) == 5
    for i, (x, y) in enumerate(got):
        assert x.dtype == torch.bfloat16 and y.dtype == torch.int64
        assert x.shape == (2, 3) and float(x[0, 0]) == i
        np.testing.assert_array_equal(y.numpy(), [2, 3])


def test_two_ranks_ldm_step(two_ranks, one_rank):
    for r in two_ranks:
        _close(r["ldm"]["losses"], one_rank["ldm"]["losses"], LOSS_RTOL, 0, "loss")
    _same_params(two_ranks, one_rank, "ldm")


def test_two_ranks_ldm_gradients_with_seeded_weights(two_ranks, one_rank):
    """Every layer active: the gradient averaged over two ranks against one
    rank's, each leaf within ``SEEDED_GRAD_TOL`` of its largest."""
    want = one_rank["ldm_seeded"]
    for r in two_ranks:
        _close(r["ldm_seeded"]["losses"], want["losses"], LOSS_RTOL, 0, "loss")
        for k, g in want["grads"].items():
            assert torch.equal(r["ldm_seeded"]["grads"][k], two_ranks[0]["ldm_seeded"]["grads"][k])
            _close(r["ldm_seeded"]["grads"][k], g, 0, SEEDED_GRAD_TOL * float(g.abs().max()), k)


def test_two_ranks_train_ldm(two_ranks, one_rank):
    """train_ldm: eval first, a padded last batch, the scale factor's
    global std; only rank 0 writes its run dir's files."""
    for r in two_ranks:
        for k in ("best_loss", "scale"):
            _close(r["train_ldm"][k], one_rank["train_ldm"][k], LOSS_RTOL, 0, k)
    assert two_ranks[0]["train_ldm"]["written"] == one_rank["train_ldm"]["written"] > 0
    assert two_ranks[1]["train_ldm"]["written"] == 0
    _same_params(two_ranks, one_rank, "train_ldm")


def test_two_ranks_stage1_step(two_ranks, one_rank):
    """The discriminator's BatchNorm statistics (and so the running ones)
    are the global batch's."""
    for r in two_ranks:
        _close(r["stage1"]["metrics"], one_rank["stage1"]["metrics"], LOSS_RTOL, 1e-7,
               "metrics")
    _same_params(two_ranks, one_rank, "stage1")


def test_two_ranks_decode_step(two_ranks, one_rank):
    """DeepSleepNet: dropout masks drawn for the global batch, BatchNorm on
    it, the weighted cross-entropy over its weight."""
    for r in two_ranks:
        _close(r["decode"]["losses"], one_rank["decode"]["losses"], LOSS_RTOL, 0, "loss")
    _same_params(two_ranks, one_rank, "decode")


def test_two_ranks_sampler(two_ranks, one_rank):
    """Each seed's window is the same over two ranks as over one; every rank
    gets the whole batch back in seed order."""
    want = one_rank["sample"]["samples"]
    assert want.shape == (16, WINDOW - 8, 1)
    for r in two_ranks:
        _close(r["sample"]["samples"], want, SAMPLE_TOL, SAMPLE_TOL, "samples")
        _close(r["sample"]["seeded"], one_rank["sample"]["seeded"], SEEDED_SAMPLE_TOL,
               SEEDED_SAMPLE_TOL, "seeded")


def test_replicate_broadcasts_rank_0(two_ranks):
    for r in two_ranks:
        assert bool((r["replicate"]["linear"] == 1.0).all())
        assert bool((r["replicate"]["state"] == 1.0).all())


def test_two_ranks_ldm_step_matches_jax_mesh(two_ranks, runs):
    """Loss and every gradient of JAX's step against the two ranks'."""
    want_loss, want_grads = runs["jax"]
    got = two_ranks[0]["jax"]
    np.testing.assert_allclose(float(got["losses"][0]), want_loss, rtol=2e-3, atol=2e-4)
    assert set(want_grads) == set(got["grads"])
    for k, v in want_grads.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), v, rtol=2e-3, atol=2e-4, err_msg=k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
