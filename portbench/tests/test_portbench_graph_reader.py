"""``sample.graph_step_pct`` on hand-made spans and counters put in place of
the program's tracer: the share of the traced batch's steps that were a
replay of the sampler's CUDA graph; None without the counter (a parent
without the graphs), without a tracer or step spans, and off CUDA."""
import pytest

from portbench import harness
from portbench.tests.test_portbench_tracing import COUNTERS, _feed, _sampler_spans
from sleepgen_torch.utils import profiling

NAME = "sample.graph_step_pct"


def _on_cuda(spans):
    return [{**s, "device_ms": 1.0} for s in spans]


def _read():
    return harness.load_module("metrics", NAME).read({})


@pytest.mark.parametrize("replays,want", [(2, 100.0), (1, 50.0), (0, 0.0)])
def test_share_of_steps_replayed(replays, want, monkeypatch):
    _feed(monkeypatch, _on_cuda(_sampler_spans()),
          {**COUNTERS, "sampler.traced_graph_replays": replays})
    assert _read() == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_counter", "off_cuda", "no_steps", "no_tracer"])
def test_none_where_there_is_nothing_to_read(case, monkeypatch):
    counters = {**COUNTERS, "sampler.traced_graph_replays": 2}
    spans = _on_cuda(_sampler_spans())
    if case == "no_counter":
        counters = COUNTERS
    elif case == "off_cuda":
        spans = _sampler_spans()
    elif case == "no_steps":
        spans = [s for s in spans if s["name"] != "sampler.step"]
    _feed(monkeypatch, spans, counters)
    if case == "no_tracer":
        monkeypatch.delattr(profiling, "spans")
    assert _read() is None


def test_the_manifest_names_it_in_the_ldm_cell():
    (m,) = [m for m in harness.manifest()["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["ldm-eeg.sample.ddim200-b64"]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
        "program_counter", "sample loop", "sample_windows_per_s", "%")
