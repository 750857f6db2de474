"""``dit.fused_norm_pct``, the share of the DiT's passes between half-blocks
that ran the program's K4, on hand-made traced runs: its share where the
program counts ``dit.fused_norms``, None without the counter (a program
without K4), a forward or a tracer, and its manifest entry in the DiT cell."""
import pytest

from portbench import harness
from portbench.tests.test_portbench_dit import CELL, _spans
from sleepgen_torch.utils import profiling

FUSED = "dit.fused_norm_pct"


@pytest.mark.parametrize("fused,want", [(10, 100.0), (4, 40.0), (0, 0.0)])
def test_the_fused_pass_reader_gives_its_share(fused, want, monkeypatch):
    """Two traced forwards of a depth-2 DiT hold 2 x 5 passes between
    half-blocks; the share of them that ran K4."""
    monkeypatch.setattr(profiling, "spans", lambda: _spans())
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"dit.forwards": 2, "dit.fused_norms": fused})
    reader = harness.load_module("metrics", FUSED)
    assert reader.read({"cfg": {"dit": {"depth": 2}}}) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_counter", "no_forwards", "no_spans", "no_tracer"])
def test_the_fused_pass_reader_gives_none_without_its_counter(case, monkeypatch):
    """A program without the counter (a parent without K4), a trace without
    a forward, a tracer that recorded nothing, or none at all."""
    counters = {"dit.forwards": 2, "dit.fused_norms": 10}
    spans = _spans()
    if case == "no_counter":
        del counters["dit.fused_norms"]
    elif case == "no_forwards":
        counters["dit.forwards"] = 0
    elif case == "no_spans":
        spans = []
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "counters", lambda: counters)
    if case == "no_tracer":
        monkeypatch.delattr(profiling, "spans")
    assert harness.load_module("metrics", FUSED).read({"cfg": {"dit": {"depth": 2}}}) is None


def test_the_manifest_names_the_fused_pass_reader_in_the_dit_cell():
    man = harness.manifest()
    got, = (m for m in man["per_layer"] if m["name"] == FUSED)
    assert got["workloads"] == [CELL] and got["source"] == "program_counter"
    assert got["moves"] == harness.workload(CELL)["rate_metric"] and got["layer"] == "model step"
