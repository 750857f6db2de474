"""The DiT-MoE cell (``dit-moe-xl2-8e2a-eeg.sample.cfg-dpm20-b64``) at tiny
widths on the CPU: a sound run of the program (bf16, as the configuration
states) is correct under the cell's limits; the fp8 reference and each
planted fault (``sample_dit``'s three and the sparse layer's four: the
second expert dropped, the top-2 weights renormalised, the shared experts
left out, each slot sent to the next expert) in the program's place are
not. A program without experts is refused before anything is drawn. The
analytic FLOP count equals ``FlopCounterMode``'s over the reference's
expert loop on real tensors; the new readers give their numbers on
hand-made spans, counters and records, None without them, and the manifest
names each, and the DiT cell's readers, in this cell."""
import copy
import time

import pytest
import torch
import yaml

from portbench import flops, harness
from portbench.reference import models as ref
from sleepgen_torch.utils import profiling

CELL = "dit-moe-xl2-8e2a-eeg.sample.cfg-dpm20-b64"
TINY_DIT = {"input_size": 256, "hidden_size": 64, "depth": 2, "num_heads": 4, "num_experts": 4,
            "n_shared_experts": 1}
TINY_AEKL = {"num_channels": [4, 4, 8]}
NEW_READERS = ["mfu.dit_moe", "dit_moe.route_ms_per_step", "dit_moe.experts_ms_per_step",
               "dit_moe.experts_roofline_pct", "dit_moe.load_max_pct"]
SHARED_READERS = ["device_idle_pct.dit", "dit.attn_ms_per_step", "dit.mlp_ms_per_step",
                  "dit.modulate_ms_per_step", "dit.fused_norm_pct"]
driver = harness.load_module("drivers", "sample_dit_moe")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def context(tmp, seconds=0.5, dit=None):
    """The cell at tiny widths (its YAML copies, cut alike, under ``tmp``)."""
    spec = copy.deepcopy(harness.workload(CELL))
    cfg = copy.deepcopy(harness.config(spec["config"]))
    cut = {**TINY_DIT, **(dit or {})}
    cfg["window"] = 4 * cut["input_size"]
    cfg["dit"].update(cut)
    cfg["aekl"].update(TINY_AEKL)
    yamls = []
    for i, path in enumerate(cfg["yaml"]):
        raw = yaml.safe_load((harness.ROOT / path).read_text())
        for section, part in (("dit", cut), ("aekl", TINY_AEKL)):
            if section in raw:
                raw[section].update(part)
        out = tmp / f"tiny{i}.yaml"
        out.write_text(yaml.safe_dump(raw))
        yamls.append(str(out))
    cfg["yaml"] = yamls
    spec.update(batch=4, check_windows=16, check_block=4, steps=3)
    return harness.Context(CELL, 2**31 + 7, seconds, False, "cpu", spec, cfg)


def test_a_sound_run_is_correct(tmp_path):
    result = harness.run_cell(context(tmp_path), time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["attempted"] % 4 == 0 and result["failed"] == 0


@pytest.mark.parametrize("stand_in", ["fp8", "unguided", "skip_block", "unscaled_attention",
                                      "top1", "renormalised", "no_shared", "expert_shift"])
def test_the_control_and_each_fault_are_not_correct(tmp_path, stand_in):
    ctx = context(tmp_path)
    seeds = list(range(ctx.seed, ctx.seed + 2 * ctx.spec["batch"]))
    if stand_in == "fp8":
        got = driver.reference_outputs(ctx.cfg, ctx.spec, ctx.seed, seeds, "cpu",
                                       ref.Precision("fp8"))
    else:
        got = driver.reference_outputs(ctx.cfg, ctx.spec, ctx.seed, seeds, "cpu",
                                       fault=driver.fault_kinds(ctx.cfg)[stand_in])
    checks = driver.check(ctx, {"windows": got[0], "latents": got[1], "seeds": seeds})
    assert any(value > limit for _, value, limit in checks), checks


def test_a_program_without_experts_is_refused_before_the_draw(tmp_path, monkeypatch):
    """A configuration the program reads without experts (as a program
    that lacks them reads this one) stops set-up before any weight."""
    ctx = context(tmp_path, dit={"num_experts": 0})
    ctx.cfg["dit"]["num_experts"] = 4
    drawn = []
    monkeypatch.setattr(driver.weights, "make_state", lambda *a, **k: drawn.append(a))
    with pytest.raises(SystemExit, match="num_experts"):
        driver.setup(ctx)
    assert not drawn


def test_the_weights_are_drawn_per_block(tmp_path):
    cfg = context(tmp_path).cfg
    state = driver.dit_weights(cfg, 5, "cpu")
    with torch.device("meta"):
        names = list(driver.reference_dit(cfg).state_dict())
    assert list(state) == names
    assert all(float(v.abs().min()) > 0 for k, v in state.items() if ".moe.gate." in k)
    again = driver.dit_weights(cfg, 5, "cpu")
    assert all(torch.equal(v, again[k]) for k, v in state.items())
    other = driver.dit_weights(cfg, 6, "cpu")
    assert not torch.equal(state["blocks.1.moe.gate.weight"], other["blocks.1.moe.gate.weight"])
    assert not torch.equal(state["blocks.0.moe.gate.weight"], state["blocks.1.moe.gate.weight"])
    assert all(torch.equal(v, v.bfloat16().float()) for v in state.values())  # as served


@pytest.mark.parametrize("rows", [1, 6])
def test_the_analytic_flop_count_equals_the_counters_over_real_routing(tmp_path, rows):
    cfg = context(tmp_path).cfg
    d = cfg["dit"]
    model = driver.common.loaded(driver.reference_dit(cfg), driver.dit_weights(cfg, 3, "cpu"))
    x = torch.randn(rows, d["in_channels"], d["input_size"])
    t = torch.randint(0, 1000, (rows,))
    y = torch.randint(0, d["num_classes"], (rows,))
    with torch.no_grad():
        counted = flops._count(lambda: model(x, t, y))
    assert driver.forward_flops(cfg, rows) == counted


MS = 1_000_000  # ns


def _spans(device=True):
    """Two forwards, each of one block whose MLP half holds the five MoE
    spans (route 1, dispatch 2, experts 10, shared 3, combine 4 device ms),
    each time doubled on the second forward."""
    spans, i = [], 1
    for k in (1, 2):
        fwd, mlp = i, i + 1
        spans.append({"name": "dit.forward", "id": fwd, "parent": None, "device_ms": None})
        spans.append({"name": "dit.mlp", "id": mlp, "parent": fwd, "device_ms": 25 * k})
        for j, (name, ms) in enumerate((("route", 1), ("dispatch", 2), ("experts", 10),
                                        ("shared", 3), ("combine", 4))):
            spans.append({"name": f"dit.moe.{name}", "id": mlp + 1 + j, "parent": mlp,
                          "device_ms": ms * k if device else None})
        i += 7
    for s in spans:
        s.update(trace=1, start_ns=0, end_ns=MS)
    return spans


def _feed(monkeypatch, spans, counters, keyed=None):
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "counters", lambda: counters)
    monkeypatch.setattr(profiling, "keyed", lambda name: dict(keyed or {}))


COUNTERS = {"dit.moe_layers": 2, "dit.routed_rows": 2 * 768}


def test_span_readers_give_their_numbers(monkeypatch, tmp_path):
    _feed(monkeypatch, _spans(), COUNTERS)
    read = lambda name: harness.load_module("metrics", name).read({"cfg": context(tmp_path).cfg})
    assert read("dit_moe.route_ms_per_step") == pytest.approx(1.5 * (1 + 2 + 4))
    assert read("dit_moe.experts_ms_per_step") == pytest.approx(15.0)
    cfg = context(tmp_path).cfg
    bound = 2 * driver.experts_bound(cfg, 768)  # two layers of 768 slots
    assert read("dit_moe.experts_roofline_pct") == pytest.approx(100 * bound / 30e-3)


@pytest.mark.parametrize("name", ["dit_moe.route_ms_per_step", "dit_moe.experts_ms_per_step",
                                  "dit_moe.experts_roofline_pct"])
def test_span_readers_give_none_without_their_spans(name, monkeypatch, tmp_path):
    run = {"cfg": context(tmp_path).cfg}
    reader = harness.load_module("metrics", name)
    _feed(monkeypatch, [s for s in _spans() if not s["name"].startswith("dit.moe.")], COUNTERS)
    assert reader.read(run) is None
    _feed(monkeypatch, _spans(device=False), COUNTERS)
    assert reader.read(run) is None  # off CUDA the spans carry no device time
    _feed(monkeypatch, [], {})
    assert reader.read(run) is None


def test_the_load_reader(monkeypatch):
    reader = harness.load_module("metrics", "dit_moe.load_max_pct")
    _feed(monkeypatch, _spans(), COUNTERS, {0: 100, 1: 300, 2: 200, 3: 200})
    assert reader.read({}) == pytest.approx(150.0)
    _feed(monkeypatch, _spans(), COUNTERS, {})
    assert reader.read({}) is None  # a program without the tally
    _feed(monkeypatch, _spans(), COUNTERS, {0: 0, 1: 0})
    assert reader.read({}) is None


def test_the_load_reader_on_the_program(tmp_path):
    """The program's own tally of a traced forward, read by the reader."""
    from sleepgen_torch.nn.dit import DiT1d

    cfg = context(tmp_path).cfg
    d = cfg["dit"]
    model = DiT1d(d["in_channels"], d["input_size"], d["patch_size"], d["hidden_size"],
                  d["depth"], d["num_heads"], d["mlp_ratio"], d["num_classes"],
                  d["num_experts"], d["num_experts_per_tok"], d["n_shared_experts"]).eval()
    profiling.reset()
    with torch.no_grad(), profiling.tracing():
        model(torch.randn(3, 1, d["input_size"]), torch.tensor([1, 2, 3]))
    rows = profiling.keyed("dit.expert_rows")
    profiling.reset()
    tokens = d["input_size"] // d["patch_size"]
    assert sum(rows.values()) == d["depth"] * 3 * tokens * d["num_experts_per_tok"]
    loads = list(rows.values())
    want = 100 * max(loads) / (sum(loads) / len(loads))
    reader = harness.load_module("metrics", "dit_moe.load_max_pct")
    import unittest.mock as mock
    with mock.patch.object(profiling, "keyed", lambda name: rows):
        assert reader.read({}) == pytest.approx(want)


def test_the_mfu_reader(tmp_path):
    cfg = context(tmp_path).cfg
    rec = {"rate": 10.0, "batch": 4, "steps": 3}
    per_batch = 3 * driver.forward_flops(cfg, 8) + driver.decode_flops(cfg, 4)
    mfu = harness.load_module("metrics", "mfu.dit_moe")
    assert mfu.read({"record": rec, "cfg": cfg}) == pytest.approx(
        100.0 * 10.0 * per_batch / 4 / flops.PEAK_BF16_FLOPS)
    assert mfu.read({"record": {}, "cfg": cfg}) is None


def test_the_manifest_names_each_reader_in_this_cell():
    man = harness.manifest()
    got = {m["name"]: m for m in man["per_layer"]}
    rate = harness.workload(CELL)["rate_metric"]
    for name in NEW_READERS:
        assert got[name]["workloads"] == [CELL] and got[name]["moves"] == rate, name
    for name in SHARED_READERS:
        assert got[name]["workloads"][-1] == CELL and got[name]["moves"] == rate, name
    assert got["dit_moe.experts_roofline_pct"]["layer"] == "kernels"
    e2e = {m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")}
    assert e2e == {"setup_s", rate}
    (c,) = [c for c in man["configs"] if c["name"] == "dit-moe-xl2-8e2a-eeg"]
    assert c["reduced"] == [] and harness.config(c["name"])["cut"].startswith("none")
