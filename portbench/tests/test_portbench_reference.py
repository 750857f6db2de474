"""The frozen plain reference against the program (sleepgen_torch) at tiny
widths in float32 on the CPU, on the weights and inputs the benchmark
makes: a UNet forward, a DDIM-3 loop with the decode and the crop, a
DPM++2M-3 loop, and one stage-2 training step. And run.py refuses to run
without a card: no fallback to the CPU."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import common, harness
from portbench.drivers import sample_dm, sample_ldm, train
from portbench.reference import loops
from portbench.tests.tiny import context

SEED = 2**31 + 3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_the_configuration_files_agree_with_their_yaml_copies():
    for name in ("ldm-eeg", "dm-eeg"):
        cfg = harness.config(name)
        prog = common.program_configs(cfg)
        u = prog[0].unet
        assert (u.image_size, u.model_channels, list(u.channel_mult), u.num_res_blocks,
                list(u.attention_resolutions), u.num_heads, u.norm_num_groups,
                u.resblock_updown, u.use_scale_shift_norm, prog[0].dtype) == (
            cfg["unet"]["image_size"], cfg["unet"]["model_channels"],
            cfg["unet"]["channel_mult"], cfg["unet"]["num_res_blocks"],
            cfg["unet"]["attention_resolutions"], cfg["unet"]["num_heads"],
            cfg["unet"]["norm_num_groups"], cfg["unet"]["resblock_updown"],
            cfg["unet"]["use_scale_shift_norm"], cfg["dtype"])
        d = prog[0].diffusion
        for key in ("timesteps", "sample_schedule", "sample_beta_start", "sample_beta_end",
                    "sample_prediction_type", "num_inference_steps"):
            assert getattr(d, key) == cfg["diffusion"][key], key
        if "aekl" in cfg:
            a = prog[1].aekl
            assert (list(a.num_channels), a.latent_channels, a.num_res_blocks,
                    a.norm_num_groups) == tuple(cfg["aekl"][k] for k in (
                        "num_channels", "latent_channels", "num_res_blocks", "norm_num_groups"))
            assert prog[0].train.batch_size == cfg["train"]["batch_size"]


def test_unet_and_aekl_forwards(tmp_path):
    from sleepgen_torch.sample.sample_ldm import build_models

    ctx = context("ldm-eeg.sample.ddim200-b64", tmp_path, dtype="float32")
    cfg, acfg = common.program_configs(ctx.cfg)
    usd, asd = common.unet_weights(ctx.cfg, SEED, "cpu"), common.aekl_weights(ctx.cfg, SEED, "cpu")
    unet, ae = build_models(cfg, common.to_numpy(usd), common.to_numpy(asd),
                            torch.device("cpu"), acfg)
    ru = common.loaded(common.reference_unet(ctx.cfg), usd)
    ra = common.loaded(common.reference_aekl(ctx.cfg), asd)
    g = torch.Generator().manual_seed(0)
    x, z = torch.randn(3, 1, 64, generator=g), torch.randn(3, 1, 64, generator=g)
    w, eps = torch.randn(3, 1, 256, generator=g), torch.randn(3, 1, 64, generator=g)
    with torch.no_grad():
        t = torch.tensor([0, 500, 999])
        torch.testing.assert_close(unet(x, t), ru(x, t), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ae.decode(z), ra.decode(z), rtol=1e-5, atol=1e-5)
        z_mu, z_sigma = ae.encode(w)
        torch.testing.assert_close(z_mu + eps * z_sigma, ra.posterior_sample(w, eps),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++2m"])
def test_ldm_sampler_with_decode_and_crop(tmp_path, sampler):
    ctx = context("ldm-eeg.sample.ddim200-b64", tmp_path, dtype="float32")
    ctx.spec.update(sampler=sampler, warm_steps=2)
    state = sample_ldm.setup(ctx)
    seeds = [SEED, SEED + 1, SEED + 7]
    got = state["sample"](ctx.spec["scale_factor"], seeds).numpy()
    want, latents = sample_ldm.reference_outputs(ctx.cfg, ctx.spec, ctx.seed, seeds, "cpu")
    assert got.shape == want.shape == (3, 256 - 72, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    kept = sample_ldm.stacked(state["latents"])
    assert kept.shape == latents.shape == (3, 1, 64)
    np.testing.assert_allclose(kept, latents, rtol=1e-4, atol=1e-5)


def test_dm_sampler_with_crop(tmp_path):
    ctx = context("dm-eeg.sample.ddim200-b64", tmp_path, dtype="float32")
    state = sample_dm.setup(ctx)
    seeds = [SEED, 5]
    got = state["sample"](seeds).numpy()
    want = sample_dm.reference_windows(ctx.cfg, ctx.spec, ctx.seed, seeds, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_dpm_timesteps_and_schedule_match_the_program():
    from sleepgen_torch.diffusion.dpm_solver import dpm_timesteps
    from sleepgen_torch.diffusion.schedules import NoiseSchedule

    sched = NoiseSchedule.create("scaled_linear_beta", 1000, 0.0015, 0.0205, "v_prediction")
    acp = loops.alphas_cumprod("scaled_linear_beta", 1000, 0.0015, 0.0205)
    np.testing.assert_array_equal(acp, sched.alphas_cumprod_host)
    for steps in (3, 20, 50):
        assert loops.dpm_timesteps(acp, steps) == dpm_timesteps(sched, steps).tolist()


def test_one_training_step(tmp_path):
    ctx = context("ldm-eeg.train.b1024", tmp_path, dtype="float32")
    state = train.setup(ctx)
    want = train.reference_steps(ctx.cfg, ctx.seed, ctx.spec["batch"], 2, "cpu")
    got = train.compare(ctx.cfg, ctx.seed, state["checked"], want, "cpu")
    assert got["loss_rel"] < 1e-6 and got["grad1_leaf"] < 1e-5 and got["change3_leaf"] < 1e-2
    np.testing.assert_allclose(state["checked"]["loss"], want["loss"], rtol=1e-6)


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                          "ldm-eeg.sample.ddim200-b64", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr
