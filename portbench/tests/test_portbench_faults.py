"""Each cell's check at tiny widths on the CPU: a sound run of the program
(bf16, as the configurations state) is correct under the cell's limits; a
run with the timed path broken underneath is not, once for each fault the
cell can have (a step that leaves its state unchanged, half of the batch
left out, an answer altered where it is produced); and the control, the
reference in fp8 in the program's place, is not correct either. The whole
run is driven (set-up, window, check), only the look for a card skipped.
One chip is all any cell uses, so no cell has an exchange to leave out."""
import time

import pytest
import torch

from portbench import harness
from portbench.drivers import sample_dm, sample_ldm, train
from portbench.reference import models as ref
from portbench.tests.tiny import context

CELLS = ["ldm-eeg.train.b1024", "ldm-eeg.sample.ddim200-b64", "dm-eeg.sample.ddim200-b64"]


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def run(ctx) -> dict:
    return harness.run_cell(ctx, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tmp_path, cell):
    result = run(context(cell, tmp_path, seconds=0.5))
    assert result["correct"], result["checks"]


def rotate(seeds):
    """Each seed's answer given for its neighbour's."""
    seeds = list(seeds)
    return seeds[1:] + seeds[:1]


def halve(seeds):
    """Half of the batch computed, the rest filled with its copies."""
    seeds = list(seeds)
    h = max(1, len(seeds) // 2)
    return (seeds[:h] * 2)[:len(seeds)]


def break_ldm_sampler(monkeypatch, alter):
    from sleepgen_torch.sample import sample_ldm as program

    real = program.make_ldm_sampler

    def broken(*args, **kwargs):
        sample = real(*args, **kwargs)
        return lambda scale_factor, seeds, *rest: sample(scale_factor, alter(seeds), *rest)

    monkeypatch.setattr(program, "make_ldm_sampler", broken)


def break_dm_loop(monkeypatch, alter):
    from sleepgen_torch.sample import samplers

    real = samplers.ddim_sample_loop

    def broken(model_fn, sched, x_T, steps, *rest):
        idx = alter(range(x_T.shape[0]))
        return real(model_fn, sched, x_T[idx], steps, *rest)

    monkeypatch.setattr(samplers, "ddim_sample_loop", broken)


def break_train_state(monkeypatch, _):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def break_train_batch(monkeypatch, _):
    from sleepgen_torch.train import train_ldm

    real = train_ldm.make_ldm_train_step

    def broken(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(x, t, noise, enc_eps, *rest):
            h = x.shape[0] // 2
            return step(x[:h], t[:h], noise[:h], enc_eps[:h], *rest)
        return half

    monkeypatch.setattr(train_ldm, "make_ldm_train_step", broken)


FAULTS = [
    ("ldm-eeg.train.b1024", "state_unchanged", break_train_state, None),
    ("ldm-eeg.train.b1024", "half_batch", break_train_batch, None),
    ("ldm-eeg.sample.ddim200-b64", "answer_altered", break_ldm_sampler, rotate),
    ("ldm-eeg.sample.ddim200-b64", "half_batch", break_ldm_sampler, halve),
    ("dm-eeg.sample.ddim200-b64", "answer_altered", break_dm_loop, rotate),
    ("dm-eeg.sample.ddim200-b64", "half_batch", break_dm_loop, halve),
]


@pytest.mark.parametrize("cell, fault, plant, alter", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault, plant, alter):
    plant(monkeypatch, alter)
    result = run(context(cell, tmp_path, seconds=0.5))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    """The reference in fp8 in the program's place, through the cell's check."""
    ctx = context(cell, tmp_path)
    fp8 = ref.Precision("fp8")
    if cell == "ldm-eeg.train.b1024":
        record = {"checked": train.reference_steps(ctx.cfg, ctx.seed, ctx.spec["batch"],
                                                   ctx.spec["check_block"], "cpu", fp8)}
        checks = train.check(ctx, record)
    elif cell == "ldm-eeg.sample.ddim200-b64":
        seeds = list(range(ctx.seed, ctx.seed + 2 * ctx.spec["batch"]))
        windows, latents = sample_ldm.reference_outputs(ctx.cfg, ctx.spec, ctx.seed, seeds, "cpu",
                                                        fp8)
        checks = sample_ldm.check(ctx, {"windows": windows, "latents": latents, "seeds": seeds})
    else:
        seeds = list(range(ctx.seed, ctx.seed + 2 * ctx.spec["batch"]))
        windows = sample_dm.reference_windows(ctx.cfg, ctx.spec, ctx.seed, seeds, "cpu", fp8)
        checks = sample_dm.check(ctx, {"windows": windows, "seeds": seeds})
    assert any(value > limit for _, value, limit in checks), checks


def test_the_ldm_int8_path_is_not_correct(tmp_path):
    """The program's own int8 sampler in the bf16 program's place: its
    latents fail the LDM cell's limit."""
    ctx = context("ldm-eeg.sample.ddim200-b64", tmp_path, seconds=0.5)
    run(ctx)
    int8 = {name[:-len(".int8")]: v for name, v in sample_ldm.control(ctx, None)
            if name.endswith(".int8")}
    assert any(int8[name] > limit for name, limit in ctx.spec["limits"].items()), int8


def test_half_a_batch_fails_the_row_number(tmp_path, monkeypatch):
    """Training's row number alone tells half a batch from rounding."""
    cell = "ldm-eeg.train.b1024"
    sound = run(context(cell, tmp_path, seconds=0.5))["checks"]["grad1_rows"]
    break_train_batch(monkeypatch, None)
    broken = run(context(cell, tmp_path, seconds=0.5))["checks"]["grad1_rows"]
    assert sound["value"] <= sound["limit"] < broken["value"], (sound, broken)
