"""``attn_fused_pct.sample`` and ``.dm``, the share of the UNet's attention
calls in the traced batch that ran the program's K5, on hand-made spans and
counters put in place of the program's tracer: its share where the program
counts ``k5.traced_launches``, None without the counter (a program without
K5), a tracer or a UNet forward, and its manifest entries in their cells."""
import pytest

from portbench import harness
from portbench.tests.test_portbench_tracing import COUNTERS, _feed, _sampler_spans
from sleepgen_torch.utils import profiling

READERS = {"attn_fused_pct.sample": "ldm-eeg.sample.ddim200-b64",
           "attn_fused_pct.dm": "dm-eeg.sample.ddim200-b64"}
STEPS = 200  # the cells' DDIM steps: a UNet forward each


def _run(cell, forwards=STEPS):
    spec = harness.workload(cell)
    return {"cfg": harness.config(spec["config"]),
            "trace": {"work": {"unet_forwards": forwards, "batch": spec["batch"]}}}


def _read(name, **kw):
    return harness.load_module("metrics", name).read(_run(READERS[name], **kw))


def test_both_cells_attend_six_times_a_forward():
    """One head of 512 at ds 4 (L 192 and 768): two blocks on the way down,
    three on the way up and the middle block's."""
    blocks = harness.load_module("metrics", "attn_fused_pct.sample").attention_blocks
    assert {blocks(_run(cell)["cfg"]["unet"]) for cell in READERS.values()} == {6}


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("launches,want", [(6 * STEPS, 100.0), (3 * STEPS, 50.0), (0, 0.0)])
def test_the_reader_gives_the_share_of_attentions_that_ran_k5(name, launches, want, monkeypatch):
    _feed(monkeypatch, _sampler_spans(), {**COUNTERS, "k5.traced_launches": launches})
    assert _read(name) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("case", ["no_counter", "no_tracer", "no_spans", "no_forward"])
def test_the_reader_gives_none_where_there_is_nothing_to_read(name, case, monkeypatch):
    """A program without the counter (a parent without K5), without a
    tracer, a tracer that recorded nothing, or a batch with no forward."""
    counters = {**COUNTERS, "k5.traced_launches": 6 * STEPS}
    spans = _sampler_spans()
    if case == "no_counter":
        counters = COUNTERS
    elif case == "no_spans":
        spans = []
    _feed(monkeypatch, spans, counters)
    if case == "no_tracer":
        monkeypatch.delattr(profiling, "spans")
    assert _read(name, forwards=0 if case == "no_forward" else STEPS) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_manifest_names_the_reader_in_its_cell(name):
    """Listed by membership of its cell, so a later cell appended to the
    entry does not break it."""
    (m,) = [m for m in harness.manifest()["per_layer"] if m["name"] == name]
    assert READERS[name] in m["workloads"]
    assert (m["source"], m["layer"], m["unit"], m["better"]) == (
        "program_counter", "kernels", "%", "higher")
    assert m["moves"] == harness.workload(READERS[name])["rate_metric"]
