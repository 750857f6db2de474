"""The DiT cell (``dit-xl2-eeg.sample.cfg-dpm20-b64``) at tiny widths on the
CPU: a sound run of the program (bf16, as the configuration states) is
correct under the cell's limits; the fp8 reference and each planted fault
(guidance off, a block skipped, attention without its scale) in the
program's place are not, and neither is a timed path that answers for the
wrong seeds. Its readers give their numbers on hand-made spans, traces and
records, None without them, and the manifest names each in this cell."""
import copy
import time

import pytest
import torch
import yaml

from portbench import harness
from portbench.reference import models as ref
from sleepgen_torch.utils import profiling

CELL = "dit-xl2-eeg.sample.cfg-dpm20-b64"
TINY_DIT = {"input_size": 64, "hidden_size": 64, "depth": 2, "num_heads": 4}
TINY_AEKL = {"num_channels": [4, 4, 8]}
READERS = ["mfu.dit", "device_idle_pct.dit", "dit.attn_ms_per_step", "dit.mlp_ms_per_step",
           "dit.modulate_ms_per_step"]
driver = harness.load_module("drivers", "sample_dit")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def context(tmp, seconds=0.5):
    """The cell at tiny widths (its YAML copies, cut alike, under ``tmp``)."""
    spec = copy.deepcopy(harness.workload(CELL))
    cfg = copy.deepcopy(harness.config(spec["config"]))
    cfg["window"] = 256
    cfg["dit"].update(TINY_DIT)
    cfg["aekl"].update(TINY_AEKL)
    yamls = []
    for i, path in enumerate(cfg["yaml"]):
        raw = yaml.safe_load((harness.ROOT / path).read_text())
        for section, cut in (("dit", TINY_DIT), ("aekl", TINY_AEKL)):
            if section in raw:
                raw[section].update(cut)
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


@pytest.mark.parametrize("stand_in", ["fp8", "unguided", "skip_block", "unscaled_attention"])
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


def test_answers_for_the_wrong_seeds_are_not_correct(tmp_path, monkeypatch):
    """The timed path's windows each given for its neighbour's seed."""
    from sleepgen_torch.sample import sample_ldm as program

    real = program.make_ldm_sampler

    def rotated(*args, **kwargs):
        sample = real(*args, **kwargs)
        return lambda scale, seeds, *rest: sample(scale, list(seeds)[1:] + list(seeds)[:1],
                                                  *rest)

    monkeypatch.setattr(program, "make_ldm_sampler", rotated)
    result = harness.run_cell(context(tmp_path), time.perf_counter())
    assert not result["correct"], result["checks"]


MS = 1_000_000  # ns


def _spans(device=True):
    """Two forwards; per forward one block: attention 10 device ms (its
    modulation 2), MLP 20 (its modulation 3), the final layer's modulation
    1 ms; each count doubled on the second forward."""
    spans, i = [], 1
    for k in (1, 2):
        fwd = i
        blocks = [("dit.attn", 10 * k, 2 * k), ("dit.mlp", 20 * k, 3 * k)]
        for j, (name, ms, mod) in enumerate(blocks):
            half = fwd + 1 + 2 * j
            spans.append({"name": "dit.modulate", "id": half + 1, "parent": half,
                          "device_ms": mod if device else None})
            spans.append({"name": name, "id": half, "parent": fwd,
                          "device_ms": ms if device else None})
        spans.append({"name": "dit.final", "id": fwd + 5, "parent": fwd, "device_ms": 1})
        spans.append({"name": "dit.modulate", "id": fwd + 6, "parent": fwd + 5, "device_ms": 1})
        spans.append({"name": "dit.forward", "id": fwd, "parent": None, "device_ms": None})
        i += 7
    for s in spans:
        s.update(trace=1, start_ns=0, end_ns=MS)
    return spans


SPAN_READS = {"dit.attn_ms_per_step": 15.0, "dit.mlp_ms_per_step": 30.0,
              "dit.modulate_ms_per_step": 7.5}


@pytest.mark.parametrize("name", sorted(SPAN_READS))
def test_span_readers_give_their_numbers(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: _spans())
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert harness.load_module("metrics", name).read({}) == SPAN_READS[name]


@pytest.mark.parametrize("name", sorted(SPAN_READS))
def test_span_readers_give_none_without_their_spans(name, monkeypatch):
    reader = harness.load_module("metrics", name)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    monkeypatch.setattr(profiling, "spans", lambda: [s for s in _spans()
                                                     if s["name"] == "dit.forward"])
    assert reader.read({}) is None
    monkeypatch.setattr(profiling, "spans", lambda: _spans(device=False))
    assert reader.read({}) is None  # off CUDA the spans carry no device time
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read({}) is None


def test_mfu_and_idle_readers(tmp_path):
    cfg = context(tmp_path).cfg
    rec = {"rate": 10.0, "batch": 4, "steps": 3}
    per_batch = 3 * driver.forward_flops(cfg, 8) + driver.decode_flops(cfg, 4)
    mfu = harness.load_module("metrics", "mfu.dit")
    assert mfu.read({"record": rec, "cfg": cfg}) == pytest.approx(
        100.0 * 10.0 * per_batch / 4 / 989e12)
    assert mfu.read({"record": {}, "cfg": cfg}) is None
    assert driver.forward_flops(cfg, 8) == 2 * driver.forward_flops(cfg, 4)
    idle = harness.load_module("metrics", "device_idle_pct.dit")
    trace = {"device_events": [("k", 0.0, 0.9)], "busy_s": 0.9, "window_s": 1.0}
    assert idle.read({"trace": trace}) == pytest.approx(10.0)
    assert idle.read({"trace": None}) is None


def test_the_manifest_names_each_reader_in_this_cell():
    man = harness.manifest()
    got = {m["name"]: m for m in man["per_layer"] if m["name"] in READERS}
    assert set(got) == set(READERS)
    for m in got.values():
        assert m["workloads"] == [CELL] and m["moves"] == harness.workload(CELL)["rate_metric"]
    e2e = {m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")}
    assert e2e == {"setup_s", harness.workload(CELL)["rate_metric"]}
