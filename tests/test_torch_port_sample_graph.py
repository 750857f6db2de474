"""The DDIM loop's one step for every step (``samplers.ddim_step_fn`` over
``schedules.ddim_tables``) on the CPU: bit for bit the loop as it was before,
with Python int timesteps and ``ddim_step``'s table lookups, at every step of
the LDM's and the DM's schedules; the loop stays eager off CUDA, with the
graph counters at 0; the entry points' outputs are unchanged; and the checks
that decide when a captured step is stale, and the launch counts a replay
adds, hold without a card. The capture and replay themselves run only on the
card (``tests/test_torch_cuda_kernels.py``).

Tiny models with seeded weights: nothing here is compared with the JAX
package.
"""
import numpy as np
import pytest
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.diffusion import schedules
from sleepgen_torch.kernels import fused_resblock
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.sample import sample_ldm, samplers
from sleepgen_torch.utils import profiling, weights

GRAPH_COUNTERS = ("sampler.graph_captures", "sampler.graph_replays",
                  "sampler.traced_graph_replays")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: its models are tiny,
    and the suite runs several worker processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _old_ddim_loop(model_fn, sched, x_T, num_inference_steps=200, eta=0.0):
    """The DDIM loop as it was before its steps were indexed on the device:
    a Python int timestep a step, the table indexed by it, ``ones_like`` at
    the last step, and ``to_x0_eps``' square roots of the gathered values."""
    ratio = sched.num_timesteps // num_inference_steps
    x = x_T.float()
    for t in schedules.ddim_timesteps(sched.num_timesteps, num_inference_steps).tolist():
        out = model_fn(x, torch.full((x.shape[0],), t, dtype=torch.int64)).float()
        shape = (1,) * x.dim()
        acp_t = sched.alphas_cumprod[t].reshape(shape)
        acp_prev = (sched.alphas_cumprod[t - ratio].reshape(shape) if t - ratio >= 0
                    else torch.ones_like(acp_t))
        sa, sb = torch.sqrt(acp_t), torch.sqrt(1.0 - acp_t)
        if sched.prediction_type == "epsilon":
            x0, eps = (x - sb * out) / sa, out
        elif sched.prediction_type == "sample":
            x0, eps = out, (x - sa * out) / sb
        else:
            x0, eps = sa * x - sb * out, sa * out + sb * x
        var = (1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)
        std = eta * torch.sqrt(var)
        x = torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev - std**2) * eps
    return x


def _recorder(seen):
    """A model of x and t that records both and depends on each."""
    def model_fn(x, t):
        seen.append((x.clone(), t.clone()))
        return torch.sin(1.3 * x + 0.01 * t.float()[:, None, None]) - 0.2 * x
    return model_fn


SCHEDULES = {
    "ldm": lambda: sample_ldm.sampling_schedule(Config()),
    "dm": lambda: sample_ldm.dm_sampling_schedule(Config(), 1000),
    "dm-table16": lambda: sample_ldm.dm_sampling_schedule(Config(), 16),
    "epsilon": lambda: schedules.NoiseSchedule.create("linear_beta", 1000, 0.0015, 0.0195,
                                                      prediction_type="epsilon"),
    "sample": lambda: schedules.NoiseSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                                                     prediction_type="sample"),
}


@pytest.mark.parametrize("name,steps", [("ldm", 200), ("dm", 200), ("dm-table16", 16),
                                        ("dm-table16", 5), ("ldm", 1), ("ldm", 7),
                                        ("ldm", 1000), ("epsilon", 50), ("sample", 50)])
def test_device_indexed_steps_give_the_int_timestep_bits(name, steps):
    """Every step's x, timestep and result equal the old loop's bit for
    bit, the last step (acp_prev 1) included."""
    sched = SCHEDULES[name]()
    x_T = torch.randn((3, 1, 16), generator=torch.Generator().manual_seed(steps))
    new, old = [], []
    got = samplers.ddim_sample_loop(_recorder(new), sched, x_T, steps)
    want = _old_ddim_loop(_recorder(old), sched, x_T, steps)
    assert len(new) == len(old) == steps
    for (x_n, t_n), (x_o, t_o) in zip(new, old):
        assert torch.equal(x_n, x_o) and torch.equal(t_n, t_o) and t_n.dtype == torch.int64
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,steps", [("ldm", 200), ("dm-table16", 16), ("ldm", 3)])
def test_the_tables_hold_ddim_steps_lookups(name, steps):
    """``ddim_tables``: the loop's timesteps, the device table's values at
    each, and at each t_prev, 1.0 where t_prev is negative; built once."""
    sched = SCHEDULES[name]()
    ts, acp_t, acp_prev = schedules.ddim_tables(sched, steps, torch.device("cpu"))
    want_ts = schedules.ddim_timesteps(sched.num_timesteps, steps)
    assert ts.dtype == torch.int64 and ts.tolist() == want_ts.tolist()
    ratio = sched.num_timesteps // steps
    for i, t in enumerate(want_ts.tolist()):
        assert torch.equal(acp_t[i], sched.alphas_cumprod[t])
        want = sched.alphas_cumprod[t - ratio] if t - ratio >= 0 else torch.tensor(1.0)
        assert torch.equal(acp_prev[i], want)
    assert acp_prev[-1].item() == 1.0
    assert schedules.ddim_tables(sched, steps, torch.device("cpu"))[0] is ts


def _ldm_config(num_classes=0):
    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = [4, 4, 8]
    cfg.unet.model_channels, cfg.unet.channel_mult = 16, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.unet.image_size, cfg.unet.num_classes = 64, num_classes
    cfg.diffusion.num_inference_steps = 4
    return cfg


def _dm_config(num_classes=0):
    cfg = _ldm_config(num_classes)
    cfg.unet.image_size = 3072
    return cfg


def _states(cfg, ldm):
    with torch.device("meta"):
        unet = sample_ldm.build_unet(cfg, 1, 1)
        ae = sample_ldm.build_aekl(cfg) if ldm else None
    return weights.seeded_state_dict(unet, 5), (weights.seeded_state_dict(ae, 6) if ldm else None)


def _trials(path, cfg, tmp_path):
    """(stop seed 3, batch 2: a padded last batch) of LDM or DM trials."""
    stage, scale = (2, 2.0) if cfg.unet.num_classes else (None, 1.0)
    if path.startswith("ldm"):
        unet_state, ae_state = _states(cfg, True)
        return sample_ldm.sample_ldm_trials(cfg, unet_state, ae_state, 1.4, tmp_path, 0, 3, 2,
                                            compute_psd=False, device="cpu", stage=stage,
                                            guidance_scale=scale)
    unet_state, _ = _states(cfg, False)
    return sample_ldm.sample_dm_trials(cfg, unet_state, tmp_path, 0, 3, 2, 16, 4, False, "cpu",
                                       stage, scale)


TRIALS = {"ldm": lambda: _ldm_config(), "ldm-guided": lambda: _ldm_config(4),
          "dm": lambda: _dm_config(), "dm-guided": lambda: _dm_config(4)}


@pytest.mark.parametrize("path", sorted(TRIALS))
def test_trials_outputs_are_unchanged(path, tmp_path, monkeypatch):
    """``sample_ldm_trials`` and ``sample_dm_trials``, plain and guided,
    give the old loop's outputs bit for bit."""
    cfg = TRIALS[path]()
    got = _trials(path, cfg, tmp_path / "new")
    monkeypatch.setitem(sample_ldm.SAMPLERS, "ddim", _old_ddim_loop)
    monkeypatch.setattr(sample_ldm, "ddim_sample_loop", _old_ddim_loop)
    monkeypatch.setattr(samplers, "ddim_sample_loop", _old_ddim_loop)
    want = _trials(path, cfg, tmp_path / "old")
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", ["ldm", "dm-guided"])
def test_the_loop_stays_eager_off_cuda(path, tmp_path):
    """On the CPU nothing is captured or replayed and no graph is kept; the
    counters are there, at 0, under the tracer too."""
    profiling.reset()
    with profiling.tracing():
        _trials(path, TRIALS[path](), tmp_path)
    counters = profiling.counters()
    assert {k: counters[k] for k in GRAPH_COUNTERS} == dict.fromkeys(GRAPH_COUNTERS, 0)
    assert len(samplers._graphs) == 0
    steps = [s for s in profiling.spans() if s["name"] == "sampler.step"]
    assert len(steps) == 2 * 4 and not any(s["name"] == "sampler.capture"
                                           for s in profiling.spans())
    profiling.reset()


def test_reset_zeroes_the_graph_counters():
    with profiling.tracing():
        for name in GRAPH_COUNTERS:
            profiling.count(name, 7)
    assert [profiling.counters()[k] for k in GRAPH_COUNTERS] == [7, 7, 7]
    profiling.reset()
    assert [profiling.counters()[k] for k in GRAPH_COUNTERS] == [0, 0, 0]


def _launches():
    c = profiling.counters()
    return c["k1.launches"], c["k3.launches"], c["k2.launches"]


def test_a_replay_adds_what_its_capture_took_back():
    """The launches counted during a capture are taken back off K1's, K2's
    and K3's counters, by shape and by form (a capture runs nothing); each
    replay adds them. The traced counts are neither taken back nor added."""
    profiling.reset()
    profiling.count("k1.launches", 3)
    profiling.count("k2.launches", 5)
    profiling.count("k1.launch_shapes", 3, key="a")
    profiling.count("k1.form.on_chip", 3)
    before = profiling.snapshot_counts()
    profiling.count("k1.launches", 2)
    profiling.count("k1.launch_shapes", key="a")
    profiling.count("k1.launch_shapes", key="b")
    profiling.count("k1.form.on_chip", 2)
    profiling.count("k2.launches", 4)
    profiling.count("k2.launch_shapes", 4, key="w")
    with profiling.tracing():
        profiling.count("k1.traced_launches", 2)
    made = profiling.take_back_counts(before)
    assert _launches() == (3, 0, 5)
    assert profiling.keyed("k1.launch_shapes") == dict(a=3)
    assert not profiling.keyed("k2.launch_shapes")
    profiling.add_counts(made, 10)
    assert _launches() == (23, 0, 45)
    assert profiling.keyed("k1.launch_shapes") == dict(a=13, b=10)
    c = profiling.counters()
    assert {k: n for k, n in c.items() if ".form." in k and n} == {"k1.form.on_chip": 23}
    assert profiling.keyed("k2.launch_shapes") == dict(w=40)
    assert c["k1.traced_launches"] == 2
    profiling.reset()


@pytest.mark.parametrize("change", ["in_place_update", "relayout", "weight_freed", "none"])
def test_a_captured_step_goes_stale_with_k2s_tiles(change):
    """A graph is fresh while every K2 tile-cache entry at its capture is
    still there for its weight at the version laid out: an in-place update,
    a re-layout or a freed weight makes it stale, and nothing else does."""
    torch.manual_seed(0)
    kept = torch.randn(128, 64, 3)
    other = torch.randn(64, 64, 3)
    fused_resblock._cached_tiles(kept, torch.bfloat16)
    fused_resblock._cached_tiles(other, torch.bfloat16)
    g = samplers._StepGraph((2, 1, 8), torch.device("cpu"), 4)
    g.tiles = fused_resblock.tiles_in_use()
    assert g.fresh()
    if change == "in_place_update":
        with torch.no_grad():
            kept.mul_(2.0)
    elif change == "relayout":
        with torch.no_grad():
            kept.add_(1.0)
        fused_resblock._cached_tiles(kept, torch.bfloat16)
    elif change == "weight_freed":
        del other
    else:
        profiling.reset()  # the counters alone
        fused_resblock._cached_tiles(torch.randn(64, 32, 3), torch.bfloat16)  # a new weight
    assert g.fresh() is (change == "none")
