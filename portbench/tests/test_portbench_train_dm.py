"""The DM training cell (``dm-eeg.train.b512``) at tiny widths on the CPU:
the reference's blocks of rows give the whole batch's gradient; a sound run
of the program (bf16, as the YAML states) is correct under the cell's
limits; the fp8 reference and the half-batch fault in the program's place
are not, nor a timed step that leaves half of its batch out. Its reader
gives its number, the training cells' trace readers and K1's and K3's
roofline reader read its profile, and the manifest names the four in this
cell."""
import time

import pytest
import torch

from portbench import harness
from portbench.reference import models as ref
from portbench.tests.tiny import context

CELL = "dm-eeg.train.b512"
driver = harness.load_module("drivers", "train_dm")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_blocks_of_rows_give_the_whole_batch(tmp_path):
    cfg = context(CELL, tmp_path, dtype="float32").cfg
    split = driver.reference_steps(cfg, 3, 4, 2, "cpu")
    whole = driver.reference_steps(cfg, 3, 4, 4, "cpu")
    assert split["loss"] == pytest.approx(whole["loss"], rel=1e-5)
    for k, g in whole["grad1"].items():
        scale = float(g.abs().max())
        torch.testing.assert_close(split["grad1"][k], g, rtol=1e-4, atol=1e-5 * scale)
        parts = sum(b[k] for b in split["grad1_blocks"]) / len(split["grad1_blocks"])
        torch.testing.assert_close(parts, g, rtol=1e-4, atol=1e-5 * scale)


def test_a_sound_run_is_correct(tmp_path):
    result = harness.run_cell(context(CELL, tmp_path, seconds=0.5), time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "train_windows_per_s", "train_peak_mem_gib"}
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("stand_in", ["fp8", "half_batch"])
def test_the_control_and_the_fault_are_not_correct(tmp_path, stand_in):
    ctx = context(CELL, tmp_path)
    spec = ctx.spec
    kw = {"prec": ref.Precision("fp8")} if stand_in == "fp8" else {"rows": spec["batch"] // 2}
    got = driver.reference_steps(ctx.cfg, ctx.seed, spec["batch"], spec["check_block"], "cpu",
                                 **kw)
    checks = driver.check(ctx, {"checked": got})
    assert any(value > limit for _, value, limit in checks), checks


def test_a_step_on_half_of_its_batch_is_not_correct(tmp_path, monkeypatch):
    from sleepgen_torch.train import train_dm

    real = train_dm.make_dm_train_step

    def halved(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda x, t, noise: step(x[: len(x) // 2], t[: len(t) // 2],
                                        noise[: len(noise) // 2])

    monkeypatch.setattr(train_dm, "make_dm_train_step", halved)
    result = harness.run_cell(context(CELL, tmp_path, seconds=0.5), time.perf_counter())
    assert not result["correct"], result["checks"]


def test_the_mfu_reader(tmp_path):
    cfg = context(CELL, tmp_path).cfg
    reader = harness.load_module("metrics", "mfu.train_dm")
    flops = driver.step_flops(cfg, 4)
    assert flops == pytest.approx(2 * driver.step_flops(cfg, 2))
    got = reader.read({"record": {"batch": 4, "step_s": 0.5}, "cfg": cfg})
    assert got == pytest.approx(100.0 * flops / 0.5 / 989e12)


def test_the_training_trace_readers_read_this_cells_profile(tmp_path):
    ctx = context(CELL, tmp_path)
    state = driver.setup(ctx)
    work = driver.profile(ctx, state)
    assert work == {"steps": ctx.spec["profile_steps"], "batch": ctx.spec["batch"]}
    trace = {"device_events": [("nchwToNhwcKernel", 0.0, 0.002), ("conv", 0.002, 0.009)],
             "window_s": 0.0125, "busy_s": 0.009, "work": work}
    layout = harness.load_module("metrics", "train.layout_ms_per_step")
    idle = harness.load_module("metrics", "device_idle_pct.train")
    assert layout.read({"trace": trace}) == pytest.approx(2.0 / work["steps"])
    assert idle.read({"trace": trace}) == pytest.approx(28.0)


def test_the_groupnorm_roofline_reader(tmp_path):
    """Its bound is the UNet's GroupNorms alone, forward and backward (the
    kernel table's 14.18 + 21.28 ms a step at 512); the share is that over
    K1's and K3's device time, and None when no such kernel ran."""
    cfg = context(CELL, tmp_path).cfg
    reader = harness.load_module("metrics", "gn_roofline_pct.train_dm")
    full = harness.config("dm-eeg")
    assert reader.step_bound(full["unet"], 512) * 1e3 == pytest.approx(14.18 + 21.28, rel=3e-3)
    work = {"steps": 3, "batch": 4}
    bound = reader.step_bound(cfg["unet"], 4, cfg["dtype"])
    events = [("gn_fwd_on_chip", 0.0, bound), ("conv", bound, 5 * bound),
              ("gn_bwd_cluster", 5 * bound, 10 * bound)]
    got = reader.read({"trace": {"device_events": events, "work": work}, "cfg": cfg})
    assert got == pytest.approx(100.0 * 3 / 6)
    none = {"device_events": [("conv", 0.0, 1.0)], "work": work}
    assert reader.read({"trace": none, "cfg": cfg}) is None


def test_the_manifest_names_the_readers_in_this_cell():
    man = harness.manifest()
    (m,) = [m for m in man["per_layer"] if m["name"] == "mfu.train_dm"]
    assert m["workloads"] == [CELL] and m["moves"] == "train_windows_per_s"
    e2e = {m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")}
    assert e2e == {"setup_s", "train_windows_per_s", "train_peak_mem_gib"}
    assert [m["name"] for m in harness.cell_metrics(man, CELL, "per_layer")] == [
        "train.layout_ms_per_step", "device_idle_pct.train", "mfu.train_dm",
        "gn_roofline_pct.train_dm"]
    spec = harness.workload(CELL)
    assert spec["batch"] == harness.config("dm-eeg")["train"]["batch_size"] == 512
