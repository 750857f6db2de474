"""The stage-1 training cell (``ldm-eeg.train-ae.b2048``) at tiny widths on the
CPU: the reference's blocks of rows give the whole batch's gradient; a
sound run of the program (bf16, as the YAML states) is correct under the
cell's limits; the fp8 reference and each planted fault (the second half
of each batch or its odd rows left out, LSGAN on the raw logits, BatchNorm
on its running statistics) in the program's place are not, nor a timed
step that leaves either half of its batch out. Its reader gives its
number, the stage-2 cell's layout and idle readers read its trace, and the
manifest names the three in this cell."""
import time

import pytest
import torch

from portbench import harness
from portbench.reference import models as ref, stage1
from portbench.tests.tiny import context

CELL = "ldm-eeg.train-ae.b2048"
driver = harness.load_module("drivers", "train_ae")
FAULTS = {"half_batch": {"rows": slice(0, 2)}, "half_batch_strided": {"rows": slice(0, None, 2)},
          "lsgan_no_leaky": {"leaky": False}, "bn_running_stats": {"running": True}}
HALVES = {"half_batch": lambda n: slice(0, n // 2), "half_batch_strided": lambda n: slice(0, n, 2)}


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_blocks_of_rows_give_the_whole_batch(tmp_path):
    """The reference's step in blocks of 2 rows gives the gradients of one
    block of 4, and its block parts sum to them."""
    cfg = context(CELL, tmp_path, dtype="float32").cfg
    ae, disc = ref.AutoencoderKL((4, 4, 8)), driver.reference_disc(cfg)
    ae.load_state_dict(driver.aekl_masters(cfg, 3, "cpu"))
    disc.load_state_dict(driver.disc_weights(cfg, 3, "cpu"))
    x, eps = driver.step_inputs(cfg, 3, 4, 0, "cpu", torch.float32)
    blocks = []
    split = stage1.train_step(ae, disc, x, eps, 0.01, 1e-9, 2, blocks=blocks)
    whole = stage1.train_step(ae, disc, x, eps, 0.01, 1e-9, 4)
    assert split[0] == pytest.approx(whole[0], rel=1e-6)
    assert split[1] == pytest.approx(whole[1], rel=1e-6)
    for net, grads in (("ae", 2), ("disc", 3)):
        for k, g in split[grads].items():
            # float32 sums taken in another order
            scale = float(g.abs().max())
            torch.testing.assert_close(g, whole[grads][k], rtol=1e-4, atol=1e-5 * scale)
            parts = sum(b[f"{net}.{k}"] for b in blocks) / len(blocks)
            torch.testing.assert_close(parts, g, rtol=1e-4, atol=1e-5 * scale)


def test_a_sound_run_is_correct(tmp_path):
    result = harness.run_cell(context(CELL, tmp_path, seconds=0.5), time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "train_windows_per_s", "train_peak_mem_gib"}


@pytest.mark.parametrize("stand_in", ["fp8", *FAULTS])
def test_the_control_and_each_fault_are_not_correct(tmp_path, stand_in):
    ctx = context(CELL, tmp_path)
    spec = ctx.spec
    kw = {"prec": ref.Precision("fp8")} if stand_in == "fp8" else FAULTS[stand_in]
    got = driver.reference_steps(ctx.cfg, ctx.seed, spec["batch"], spec["check_block"], "cpu",
                                 **kw)
    checks = driver.check(ctx, {"checked": got})
    assert any(value > limit for _, value, limit in checks), checks


@pytest.mark.parametrize("half", HALVES)
def test_a_step_on_half_of_its_batch_is_not_correct(tmp_path, monkeypatch, half):
    from sleepgen_torch.train import train_aekl

    real = train_aekl.make_train_step
    rows = HALVES[half]

    def halved(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda x, eps: step(x[rows(x.shape[0])], eps[rows(eps.shape[0])])

    monkeypatch.setattr(train_aekl, "make_train_step", halved)
    result = harness.run_cell(context(CELL, tmp_path, seconds=0.5), time.perf_counter())
    assert not result["correct"], result["checks"]


def test_the_mfu_reader(tmp_path):
    cfg = context(CELL, tmp_path).cfg
    reader = harness.load_module("metrics", "mfu.train_ae")
    flops = driver.step_flops(cfg, 4)
    assert flops == pytest.approx(2 * driver.step_flops(cfg, 2))
    got = reader.read({"record": {"batch": 4, "step_s": 0.5}, "cfg": cfg})
    assert got == pytest.approx(100.0 * flops / 0.5 / 989e12)


def test_the_stage_two_trace_readers_read_this_cells_profile(tmp_path):
    """``train.layout_ms_per_step`` and ``device_idle_pct.train`` read the
    trace of this driver's ``profile`` (the stage-2 cell's): the layout
    transposes' device ms over its steps, and the idle share; None from a
    trace with no device events."""
    ctx = context(CELL, tmp_path)
    state = driver.setup(ctx)
    work = driver.profile(ctx, state)
    assert work == {"steps": ctx.spec["profile_steps"], "batch": ctx.spec["batch"]}
    trace = {"device_events": [("nchwToNhwcKernel", 0.0, 0.002), ("conv", 0.002, 0.009),
                               ("nhwcToNchwKernel", 0.009, 0.010)],
             "window_s": 0.0125, "busy_s": 0.010, "work": work}
    layout = harness.load_module("metrics", "train.layout_ms_per_step")
    idle = harness.load_module("metrics", "device_idle_pct.train")
    assert layout.read({"trace": trace}) == pytest.approx(3.0 / work["steps"])
    assert idle.read({"trace": trace}) == pytest.approx(20.0)
    bare = {**trace, "device_events": []}
    assert layout.read({"trace": bare}) is None and idle.read({"trace": bare}) is None


def test_the_manifest_names_the_reader_in_this_cell():
    man = harness.manifest()
    (m,) = [m for m in man["per_layer"] if m["name"] == "mfu.train_ae"]
    assert m["workloads"] == [CELL] and m["moves"] == "train_windows_per_s"
    e2e = {m["name"] for m in harness.cell_metrics(man, CELL, "end_to_end")}
    assert e2e == {"setup_s", "train_windows_per_s", "train_peak_mem_gib"}
    assert [m["name"] for m in harness.cell_metrics(man, CELL, "per_layer")] == [
        "train.layout_ms_per_step", "device_idle_pct.train", "mfu.train_ae"]
