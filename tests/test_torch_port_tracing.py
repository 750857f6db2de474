"""The port's tracer (``sleepgen_torch/utils/profiling.py``) on the CPU:
off by default; under ``tracing()`` or a torch.profiler session the
sampler's and the training step's spans nest as the layers do, share one
trace id per call, land in the profiler's Chrome trace on its clock, and
change no output; the in-memory list is capped.

Tiny models (UNet model_channels 32, channel_mult (1, 2), latent 64; AEKL
[4, 4, 8]) with torch's own initial weights: nothing here is compared with
the JAX package.
"""
import copy
import json

import pytest
import torch

from sleepgen_torch.diffusion import schedules
from sleepgen_torch.nn.aekl import AutoencoderKL
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.sample.sample_ldm import make_dm_sampler, make_ldm_sampler
from sleepgen_torch.train import train_ldm as T
from sleepgen_torch.utils import profiling

LATENT, STEPS, SEEDS, SF = 64, 4, [0, 1], 1.7
UNET_KW = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
               attention_resolutions=(2,), num_groups=8)
SAMPLER_SPANS = {"sampler.call", "sampler.noise", "sampler.step", "unet.forward",
                 "sampler.update", "sampler.decode"}
PHASES = ["trainer.encode", "trainer.forward", "trainer.backward", "trainer.optimizer"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: its models are tiny,
    and the suite runs several worker processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    ae = AutoencoderKL(num_channels=(4, 4, 8), latent_channels=1)
    return UNet1d(**UNET_KW).eval(), ae.eval()


def _sampler(models, sampler="ddim"):
    unet, ae = models
    sched = schedules.NoiseSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205,
                                           prediction_type="v_prediction")
    return make_ldm_sampler(unet, ae, sched, latent_len=LATENT, num_inference_steps=STEPS,
                            sampler=sampler, device="cpu")


def _dm_sample(models):
    """The DM's ancestral sampler over a table of STEPS timesteps."""
    sched = schedules.NoiseSchedule.create("linear_beta", STEPS, 0.0015, 0.0195)
    torch.manual_seed(4)
    unet = UNet1d(in_channels=1, out_channels=1, **UNET_KW).eval()
    sample = make_dm_sampler(unet, sched, signal_len=4 * LATENT, device="cpu")
    return sample(SEEDS, torch.Generator().manual_seed(3))


def _trainer(models):
    """Two Adam steps of a stage-2 train step from torch's initial UNet."""
    torch.manual_seed(1)
    unet = UNet1d(**UNET_KW).train()
    ae = copy.deepcopy(models[1]).requires_grad_(False)
    sched = schedules.NoiseSchedule.create("linear_beta", 12, 0.0015, 0.0195)
    opt = torch.optim.Adam(unet.parameters(), lr=1e-3)
    step = T.make_ldm_train_step(unet, ae, sched, opt, 1.3)
    gen = torch.Generator().manual_seed(2)
    losses = []
    for _ in range(2):
        x = torch.randn((3, 1, 4 * LATENT), generator=gen)
        t, noise, enc_eps = T.draw_step_inputs(gen, 3, (1, LATENT), 12)
        losses.append(step(x, t, noise, enc_eps))
    return torch.stack(losses), {k: p.detach().clone() for k, p in unet.named_parameters()}


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def _children(spans, parent):
    return sorted((s for s in spans if s["parent"] == parent["id"]), key=lambda s: s["start_ns"])


def _host_counters():
    return {k: v for k, v in profiling.counters().items() if ".host_ns" in k or ".traced_" in k}


# Every key of ``counters()``, each at 0 until counted once the samplers
# are imported, as every `portbench` run imports them
COUNTER_KEYS = {f"{k}.launches" for k in ("k1", "k2", "k3", "k4", "k5")} | {
    f"{k}.{c}" for k in ("k1", "k2", "k3") for c in ("host_ns", "traced_launches")} | {
    "k2.relayouts", "k2.traced_relayouts", "sampler.graph_captures", "sampler.graph_replays",
    "sampler.traced_graph_replays", "dit.forwards", "dit.tokens", "dit.fused_norms",
    "dit.moe_layers", "dit.routed_rows", "spans.dropped", "k5.traced_launches", "k5.declined"} | {f"k1.form.{f}" for f in ("on_chip", "cluster", "streaming")} | {
    f"k3.form.{f}" for f in ("on_chip", "cluster", "three_pass")} | {
    f"k2.form.{f}" for f in ("tma", "elem")}


def test_counters_hold_every_key_and_k4s_launches():
    """``counters()`` holds every key at 0, K4's launches among them, and a
    K4 launch's count (here counted as K4's wrapper counts it) shows there
    until ``reset()``."""
    counters = profiling.counters()
    assert set(counters) == COUNTER_KEYS and set(counters.values()) == {0}
    profiling.count("k4.launches")
    assert profiling.counters()["k4.launches"] == 1
    profiling.reset()
    assert profiling.counters()["k4.launches"] == 0


def test_tracing_is_off_by_default(models):
    assert not profiling.recording()
    assert profiling.span("sampler.call") is profiling.span("unet.forward")  # the shared no-op
    _sampler(models)(SF, SEEDS)
    assert profiling.spans() == []
    assert set(_host_counters().values()) == {0}
    assert profiling.counters()["spans.dropped"] == 0


@pytest.mark.parametrize("sampler", ["ddim", "dpm++2m", "dm-ddpm"])
def test_sampler_spans_nest_as_the_layers(models, sampler):
    with profiling.tracing():
        assert profiling.recording()
        if sampler == "dm-ddpm":
            _dm_sample(models)
        else:
            _sampler(models, sampler)(SF, SEEDS)
    assert not profiling.recording()
    spans = profiling.spans()
    (call,) = _by_name(spans, "sampler.call")
    assert call["parent"] is None and call["trace"] == call["id"]
    assert {s["trace"] for s in spans} == {call["id"]}
    steps = _by_name(spans, "sampler.step")
    assert len(steps) == STEPS
    want = ["sampler.noise"] + ["sampler.step"] * STEPS
    want += [] if sampler == "dm-ddpm" else ["sampler.decode"]
    assert [s["name"] for s in _children(spans, call)] == want
    for step in steps:
        assert [s["name"] for s in _children(spans, step)] == ["unet.forward", "sampler.update"]
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
    assert {s["name"] for s in spans} <= SAMPLER_SPANS


def test_spans_share_the_profiler_clock(models, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        # torch's first annotation of a session sets itself up after its stamp
        with profiling.span("warm-up"):
            pass
        _sampler(models)(SF, SEEDS)
    assert not profiling.recording()
    mine = [s for s in profiling.spans() if s["name"] != "warm-up"]
    assert len(_by_name(mine, "sampler.step")) == STEPS
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_ns = int(trace["baseTimeNanoseconds"])
    theirs = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name") in SAMPLER_SPANS]
    assert len(theirs) == len(mine)
    for name in SAMPLER_SPANS:
        ours = sorted(s["start_ns"] for s in _by_name(mine, name))
        seen = sorted(float(e["ts"]) for e in theirs if e["name"] == name)
        assert len(ours) == len(seen), name
        for ns, ts_us in zip(ours, seen):
            assert abs((ns - base_ns) / 1e3 - ts_us) < 50.0, (name, ns, ts_us)


def test_train_step_spans_its_phases(models):
    with profiling.tracing():
        _trainer(models)
    spans = profiling.spans()
    steps = _by_name(spans, "trainer.step")
    assert len(steps) == 2
    for step in steps:
        assert step["parent"] is None
        kids = _children(spans, step)
        assert [s["name"] for s in kids] == PHASES
        assert all(s["trace"] == step["id"] for s in kids)
        (fwd,) = _by_name(_children(spans, kids[1]), "unet.forward")
        assert fwd["trace"] == step["id"]
    assert all(s["device_ms"] is None for s in spans)


@pytest.mark.parametrize("path", ["ddim", "dpm++2m", "dm-ddpm", "train"])
def test_tracing_changes_no_output(models, path):
    def run():
        if path == "train":
            losses, params = _trainer(models)
            return [losses, *params.values()]
        return [_dm_sample(models) if path == "dm-ddpm" else _sampler(models, path)(SF, SEEDS)]

    off = run()
    with profiling.tracing():
        on = run()
    assert profiling.spans()
    assert len(off) == len(on) and all(torch.equal(x, y) for x, y in zip(off, on))


def test_the_cap_drops_and_counts_and_reset_clears(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.tracing():
        with profiling.span("sampler.call"):
            for _ in range(4):
                with profiling.span("sampler.step"):
                    pass
    spans = profiling.spans()
    assert [s["name"] for s in spans] == ["sampler.step"] * 3
    assert profiling.counters()["spans.dropped"] == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters()["spans.dropped"] == 0
