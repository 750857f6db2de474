"""The readers of the program's spans and counters, on hand-made lists put in
place of the tracer's (``sleepgen_torch.utils.profiling.spans`` and
``counters``): each gives its number, None where its spans are missing,
None where the program has no tracer (a parent without one), and the train
readers None off CUDA."""
import pytest

from portbench import harness
from sleepgen_torch.utils import profiling

MS = 1_000_000  # ns


def _span(i, name, parent, start_ms, end_ms, device_ms=None):
    return {"name": name, "id": i, "parent": parent, "trace": 1, "start_ns": start_ms * MS,
            "end_ns": end_ms * MS, "device_ms": device_ms}


def _sampler_spans():
    """One call: noise 1 ms, two steps of 10 and 14 ms (UNet 8 and 12, update
    1 each), a decode of 6 ms."""
    spans = [_span(2, "sampler.noise", 1, 0, 1)]
    t, i = 1, 3
    for length, unet in ((10, 8), (14, 12)):
        step = i
        spans += [_span(step + 1, "unet.forward", step, t, t + unet),
                  _span(step + 2, "sampler.update", step, t + unet, t + unet + 1),
                  _span(step, "sampler.step", 1, t, t + length)]
        t, i = t + length, i + 3
    spans += [_span(i, "sampler.decode", 1, t, t + 6), _span(1, "sampler.call", None, 0, t + 6)]
    return spans


def _train_spans(device=True):
    """Two steps; phases of 30, 100, 200 and 5 device ms, the second step's
    each 2 ms longer; an eval's encode outside any step."""
    spans, i = [], 1
    for k in range(2):
        step = i
        for j, (name, ms) in enumerate((("trainer.encode", 30), ("trainer.forward", 100),
                                        ("trainer.backward", 200), ("trainer.optimizer", 5))):
            spans.append(_span(step + 1 + j, name, step, j, j + 1, ms + 2 * k if device else None))
        spans.append(_span(step, "trainer.step", None, 0, 4, 340 if device else None))
        i += 5
    spans.append(_span(i, "trainer.encode", None, 10, 11, 99.0 if device else None))
    return spans


COUNTERS = {"k1.host_ns": 30_000, "k2.host_ns": 90_000, "k3.host_ns": 0,
            "k1.traced_launches": 1, "k2.traced_launches": 3, "k3.traced_launches": 0,
            "k2.traced_relayouts": 0, "spans.dropped": 0}

EXPECTED = {"sample.step_host_ms": 12.0, "sample.unet_host_ms_per_step": 10.0,
            "sample.kernel_host_us_per_launch": 30.0, "sample.decode_host_ms": 6.0,
            "sample.k2_relayouts": 0.0, "train.encode_ms": 31.0, "train.forward_ms": 101.0,
            "train.backward_ms": 201.0, "train.optimizer_ms": 6.0}


def _feed(monkeypatch, spans, counters=COUNTERS):
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))


def _read(name):
    return harness.load_module("metrics", name).read({})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_its_number(name, monkeypatch):
    _feed(monkeypatch, _sampler_spans() if name.startswith("sample.") else _train_spans())
    assert _read(name) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_without_its_spans(name, monkeypatch):
    other = _train_spans() if name.startswith("sample.") else _sampler_spans()
    for spans in ([], other):
        _feed(monkeypatch, spans)
        assert _read(name) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_where_the_program_has_no_tracer(name, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert _read(name) is None


@pytest.mark.parametrize("name", [n for n in sorted(EXPECTED) if n.startswith("train.")])
def test_train_readers_give_none_off_cuda(name, monkeypatch):
    _feed(monkeypatch, _train_spans(device=False))
    assert _read(name) is None


def test_relayouts_count_per_call(monkeypatch):
    _feed(monkeypatch, _sampler_spans(), {**COUNTERS, "k2.traced_relayouts": 38})
    assert _read("sample.k2_relayouts") == 38.0


def test_the_manifest_names_each_reader_in_its_cell():
    man = harness.manifest()
    got = {m["name"]: m for m in man["per_layer"] if m["name"] in EXPECTED}
    assert set(got) == set(EXPECTED)
    for name, m in got.items():
        cell = "ldm-eeg.sample.ddim200-b64" if name.startswith("sample.") else "ldm-eeg.train.b1024"
        assert m["workloads"] == [cell]
        assert m["source"] in ("program_span", "program_counter")
