"""The port's serving path on the CPU: stage-conditional and guided sampling
against the JAX package, ``SamplerService``, and the ``serve``,
``warm-cache`` and ``sample --stage`` CLIs.

Against JAX (fp32, the model bound rtol 2e-3 / atol 2e-4 of
tests/test_torch_import.py): test_torch_port_parity's tiny UNet (model
channels 32, channel_mult (1, 2), attention at ds 2, G 8, latent 64) with
5 classes and every weight, the label embedding included, drawn from
numpy, and its AEKL [4, 4, 8]. The service and the CLIs read port run dirs
with seeded weights (UNet model channels 16, AEKL [2, 2, 4], latent 64,
4 steps, batch 4).
"""
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.diffusion import NoiseSchedule as JaxSchedule
from sleepgen.diffusion.dpm_solver import dpm_solver_pp_2m_sample_loop as jax_dpm_loop
from sleepgen.nn import AutoencoderKL as JaxAEKL
from sleepgen.sample import samplers as jax_samplers
from sleepgen_torch.config import Config
from sleepgen_torch.sample import samplers
from sleepgen_torch.sample.sample_ldm import (build_aekl, build_unet, make_ldm_sampler,
                                              sample_ldm_trials, sampling_schedule)
from sleepgen_torch.serve import SamplerService
from sleepgen_torch.utils import weights

from test_torch_port_parity import (LATENT, _jax_unet, _port_unet, _t, aekl_pair,  # noqa: F401
                                    unet_pair)

RTOL, ATOL = 2e-3, 2e-4
N_CLASSES = 5
SCALE_FACTOR = 1.3
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: the suite runs several
    worker processes on the same cores, where each process's spinning
    thread pool slows every small op of the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cond_pair():
    jm, params = _jax_unet(N_CLASSES)
    return jm, params, _port_unet(params, N_CLASSES)


def _schedules():
    d = Config().diffusion
    args = (d.sample_schedule, d.timesteps, d.sample_beta_start, d.sample_beta_end)
    return (JaxSchedule.create(*args, prediction_type=d.sample_prediction_type),
            sampling_schedule(Config()))


LABELS = np.array([2, 0, 4], np.int32)


@pytest.mark.parametrize("mode", ["plain", "conditional", "guided"])
def test_cond_model_fn_matches_jax(unet_pair, cond_pair, mode):
    """The same x, t and labels through JAX's ``_cond_model_fn`` and the
    port's ``cond_model_fn``; guided at scale 2.5."""
    jm, params, pm = unet_pair if mode == "plain" else cond_pair
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, LATENT, 1)).astype(np.float32)
    t = np.array([17, 500, 931], np.int32)
    labels = None if mode == "plain" else LABELS
    scale = 2.5 if mode == "guided" else 1.0
    fn = jax_samplers._cond_model_fn(jm, params, None if labels is None else jnp.asarray(labels),
                                     scale)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = samplers.cond_model_fn(pm, None if labels is None else _t(labels).long(),
                                     scale)(_t(x.transpose(0, 2, 1)), _t(t).long())
    assert float(np.abs(want).mean()) > 0.1
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, rtol=RTOL, atol=ATOL)


def test_guided_model_fn_runs_one_forward_of_twice_the_batch(cond_pair):
    _, _, pm = cond_pair
    batches = []
    hook = pm.register_forward_hook(lambda m, args, out: batches.append(args[0].shape[0]))
    try:
        with torch.no_grad():
            fn = samplers.cond_model_fn(pm, _t(LABELS).long(), 2.0)
            out = fn(torch.randn(3, 1, LATENT), torch.full((3,), 10))
    finally:
        hook.remove()
    assert batches == [6] and out.shape == (3, 1, LATENT) and out.dtype == torch.float32


@pytest.mark.parametrize("sampler", ["ddim", "dpm++2m"])
@pytest.mark.parametrize("guided", [False, True], ids=["conditional", "guided"])
def test_conditional_loops_with_decode_match_jax(cond_pair, aekl_pair, sampler, guided):
    """The same x_T through JAX's loop (DDIM or DPM++2M, 4 steps) with its
    ``_cond_model_fn`` and decode, and through the port's
    ``make_ldm_sampler``; labels one per seed, guidance scale 2.0."""
    jm, params, pm = cond_pair
    ajm, ae_params, apm = aekl_pair
    js, ps = _schedules()
    seeds = [0, 1, 2]
    x_T = samplers.seed_noise(seeds, (LATENT, 1), "cpu").numpy()
    scale = 2.0 if guided else 1.0
    jax_loop = jax_dpm_loop if sampler == "dpm++2m" else jax_samplers.ddim_sample_loop

    def jax_sample(x):
        fn = jax_samplers._cond_model_fn(jm, params, jnp.asarray(LABELS), scale, guided=guided)
        z = jax_loop(fn, js, x, STEPS)
        sig = ajm.apply({"params": ae_params}, z / SCALE_FACTOR,
                        method=JaxAEKL.decode_stage_2_outputs)
        return sig[:, 36:-36, :]

    want = np.asarray(jax.jit(jax_sample)(x_T))
    got = make_ldm_sampler(pm, apm, ps, latent_len=LATENT, num_inference_steps=STEPS,
                           sampler=sampler, device="cpu", conditional=True, guided=guided)(
        SCALE_FACTOR, seeds, _t(LABELS).long(), scale if guided else None)
    assert got.shape == want.shape == (3, 4 * LATENT - 72, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


VALIDATE_CASES = [(5, 0, 1.0), (5, 4, 2.0), (0, None, 1.0), (5, None, 1.0), (5, -1, 1.0),
                  (5, 5, 1.0), (5, 2.5, 1.0), (0, 0, 1.0), (0, None, 2.0), (3, None, 2.0)]


@pytest.mark.parametrize("num_classes,stage,scale", VALIDATE_CASES)
def test_validate_stage_matches_jax(num_classes, stage, scale):
    def outcome(fn):
        try:
            fn(num_classes, stage, scale)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(samplers.validate_stage) == outcome(jax_samplers.validate_stage)


def test_conditional_sampler_takes_labels_and_guided_takes_a_scale(cond_pair, aekl_pair):
    _, _, pm = cond_pair
    _, _, apm = aekl_pair
    kw = dict(latent_len=LATENT, num_inference_steps=1, device="cpu", conditional=True)
    with pytest.raises(ValueError, match="needs labels"):
        make_ldm_sampler(pm, apm, _schedules()[1], **kw)(1.0, [0])
    with pytest.raises(ValueError, match="needs guidance_scale"):
        make_ldm_sampler(pm, apm, _schedules()[1], guided=True, **kw)(1.0, [0], _t(LABELS[:1]))
    with pytest.raises(ValueError, match="requires a conditional"):
        make_ldm_sampler(pm, apm, _schedules()[1], latent_len=LATENT, device="cpu", guided=True)


# -- the service and the CLIs, on port run dirs --------------------------------

def _serve_config(num_classes: int) -> Config:
    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = [2, 2, 4]
    cfg.unet.model_channels, cfg.unet.channel_mult = 16, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.unet.num_classes, cfg.unet.image_size = num_classes, LATENT
    cfg.diffusion.num_inference_steps = STEPS
    cfg.diffusion.sampler = "dpm++2m" if num_classes else "ddim"
    cfg.discriminator.num_channels = 4
    cfg.train.batch_size = 2
    return cfg


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """An AEKL run dir and two LDM run dirs, conditional (5 classes,
    DPM++2M) and unconditional (DDIM), with seeded weights: the label
    embedding and the output convolution are non-zero."""
    root = tmp_path_factory.mktemp("serve")
    cfg = _serve_config(0)
    with torch.device("meta"):
        ae = build_aekl(cfg)
    (root / "aekl").mkdir()
    cfg.to_yaml(root / "aekl" / "config.yaml")
    weights.save_params_npz(root / "aekl" / "params.npz",
                            {"params": weights.aekl_state_to_jax(weights.seeded_state_dict(ae, 1))})
    for name, classes in (("ldm", 0), ("cond_ldm", N_CLASSES)):
        cfg = _serve_config(classes)
        with torch.device("meta"):
            unet = build_unet(cfg, 1, 1)
        (root / name).mkdir()
        cfg.to_yaml(root / name / "config.yaml")
        weights.save_params_npz(root / name / "params.npz", {"params": weights.unet_state_to_jax(
            weights.seeded_state_dict(unet, 2 + classes))})
        (root / name / "scale_factor.txt").write_text(str(SCALE_FACTOR))
    return root


def _service(run_dirs, ldm="cond_ldm"):
    return SamplerService.from_run_dirs(run_dirs / "aekl", run_dirs / ldm, batch_size=4,
                                        device="cpu")


@pytest.fixture(scope="module")
def cond_svc(run_dirs):
    return _service(run_dirs)


def test_service_reads_port_run_dirs(cond_svc):
    assert cond_svc.conditional and cond_svc.device == torch.device("cpu")
    assert cond_svc.scale_factor == SCALE_FACTOR and cond_svc.batch_size == 4
    emb = cond_svc._unet.label_emb.weight.detach()
    assert emb.shape[0] == N_CLASSES and float(emb.abs().min()) > 0
    assert float(cond_svc._unet.out["2"].weight.abs().mean()) > 0


def test_service_requires_a_stage(cond_svc):
    with pytest.raises(ValueError, match="pass stage=0..4"):
        cond_svc.sample(range(4))


def test_service_output_shape_and_finite(cond_svc):
    out = cond_svc.sample(range(6), stage=2)
    assert out.shape == (6, 4 * LATENT - 72, 1) and out.dtype == np.float32
    assert np.isfinite(out).all()


@pytest.mark.parametrize("scale", [1.0, 2.0], ids=["plain", "guided"])
def test_service_seed_is_bitwise_deterministic_across_chunking_and_padding(cond_svc, scale):
    """Seed 1 alone (padded to the batch with copies of itself) equals
    seed 1 inside a batch; seeds 0-5 in a full and a padded chunk equal
    seeds 0-3 and 4-5 asked for apart."""
    kw = dict(stage=2, guidance_scale=scale)
    batch = cond_svc.sample(range(4), **kw)
    np.testing.assert_array_equal(cond_svc.sample([1], **kw)[0], batch[1])
    six = cond_svc.sample(range(6), **kw)
    np.testing.assert_array_equal(six[:4], batch)
    np.testing.assert_array_equal(six[4:], cond_svc.sample([4, 5], **kw))


def test_guidance_changes_samples_and_the_cache_keeps_two_samplers(run_dirs):
    svc = _service(run_dirs)
    plain = svc.sample(range(4), stage=2)
    guided = svc.sample(range(4), stage=2, guidance_scale=2.0)
    guided3 = svc.sample(range(4), stage=2, guidance_scale=3.0)
    assert not np.allclose(guided, plain) and not np.allclose(guided3, guided)
    assert not np.allclose(svc.sample(range(4), stage=3), plain)
    assert set(svc._samplers) == {(4, False), (4, True)}


def _forwards(svc):
    """A list that records the batch of each UNet forward of ``svc``."""
    batches = []
    svc._unet.register_forward_hook(lambda m, args, out: batches.append(args[0].shape[0]))
    return batches


def test_guided_request_runs_one_forward_of_twice_the_batch_per_step(run_dirs):
    svc = _service(run_dirs)
    batches = _forwards(svc)
    svc.sample(range(4), stage=1, guidance_scale=2.0)
    assert batches == [8] * STEPS
    batches.clear()
    svc.sample(range(4), stage=1)
    assert batches == [4] * STEPS


@pytest.mark.parametrize("stage", [-1, N_CLASSES, None])
def test_service_rejects_stages_before_queuing_anything(run_dirs, stage):
    svc = _service(run_dirs)
    batches = _forwards(svc)
    with pytest.raises(ValueError):
        svc.sample_async(range(4), stage=stage, guidance_scale=2.0)
    assert batches == [] and svc._samplers == {}


@pytest.mark.parametrize("kw", [dict(stage=0), dict(guidance_scale=2.0)], ids=["stage", "scale"])
def test_unconditional_service_rejects_a_stage_and_a_guidance_scale(run_dirs, kw):
    svc = _service(run_dirs, "ldm")
    assert not svc.conditional
    with pytest.raises(ValueError, match="unconditional|class-conditional"):
        svc.sample(range(4), **kw)
    assert svc.sample(range(2)).shape == (2, 4 * LATENT - 72, 1)


@pytest.mark.parametrize("ldm,kw", [("cond_ldm", dict(stage=2, guidance_scale=2.0)),
                                    ("ldm", {})], ids=["guided", "unconditional"])
def test_service_equals_sample_ldm_trials(run_dirs, tmp_path, ldm, kw):
    from sleepgen_torch.sample.sample_ldm import read_run_dirs

    svc = _service(run_dirs, ldm)
    cfg, aekl_cfg, unet_state, ae_state, sf = read_run_dirs(run_dirs / "aekl", run_dirs / ldm)
    want = sample_ldm_trials(cfg, unet_state, ae_state, sf, tmp_path, 0, 6, batch_size=4,
                             aekl_cfg=aekl_cfg, compute_psd=False, device="cpu", **kw)
    np.testing.assert_array_equal(svc.sample(range(6), **kw), want)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"sample_{i}.npy" for i in range(6))


def test_result_is_idempotent_and_sets_stats(run_dirs):
    svc = _service(run_dirs)
    assert svc.warmup() > 0 and svc.stats == {}
    assert set(svc._samplers) == {(4, False), (4, True)}
    pending = svc.sample_async(range(5), stage=4)
    first = pending.result()
    assert pending.result() is first
    assert svc.stats["last_windows"] == 5
    assert svc.stats["last_sec"] > 0 and svc.stats["last_windows_per_sec"] > 0


def test_sample_with_psd_shapes(cond_svc):
    sigs, psds, freqs = cond_svc.sample_with_psd(range(3), stage=0)
    assert sigs.shape == (3, 4 * LATENT - 72, 1)
    assert psds.shape == (3, len(freqs)) and freqs.max() <= 18.0 and np.isfinite(psds).all()


def _umbrella(monkeypatch, *argv, stdin: str | None = None):
    from sleepgen_torch.__main__ import main

    monkeypatch.setattr(sys, "argv", ["sleepgen_torch", *argv])
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    return main()


def _serve(monkeypatch, run_dirs, out, *flags, stdin=""):
    return _umbrella(monkeypatch, "serve", "--best_model_path", str(run_dirs / "aekl"),
                     "--diffusion_path", str(run_dirs / "cond_ldm"), "--output_dir", str(out),
                     "--batch_size", "4", "--device", "cpu", *flags, stdin=stdin)


REQUESTS = "\n".join([
    json.dumps({"seeds": [0, 1, 2], "stage": 2}),
    json.dumps({"seeds": [0, 1]}),  # no stage and no --stage: an error line
    json.dumps({"start": 2, "stop": 7, "stage": 1, "guidance_scale": 2.0}),
    "not json",
    json.dumps({"seeds": [4, 5], "stage": N_CLASSES}),  # out of range
    json.dumps({"seeds": [4, 5], "stage": 3}),
]) + "\n"


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def strict_run(run_dirs, tmp_path_factory):
    """The serve CLI in strict mode over REQUESTS: (output dir, stdout)."""
    out = tmp_path_factory.mktemp("strict")
    with pytest.MonkeyPatch.context() as mp:
        buf = io.StringIO()
        mp.setattr(sys, "stdout", buf)
        _serve(mp, run_dirs, out, stdin=REQUESTS)
    return out, buf.getvalue()


def test_serve_cli_strict_answers_each_request(strict_run, cond_svc):
    out, stdout = strict_run
    assert stdout.splitlines()[1].startswith("ready (warm-up ")
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    assert [(r["request"], "error" in r) for r in lines] == [
        (0, False), (1, True), (2, False), (3, True), (4, True), (5, False)]
    assert [r["n"] for r in lines if "n" in r] == [3, 5, 2]
    np.testing.assert_array_equal(np.load(out / "signals_0.npy"),
                                  cond_svc.sample([0, 1, 2], stage=2))
    np.testing.assert_array_equal(np.load(out / "signals_2.npy"),
                                  cond_svc.sample(range(2, 7), stage=1, guidance_scale=2.0))
    assert sorted(p.name for p in out.iterdir()) == [f"signals_{i}.npy" for i in (0, 2, 5)]


def test_serve_cli_reports_bad_requests_and_keeps_serving(strict_run):
    _, stdout = strict_run
    errors = {r["request"]: r["error"] for r in map(json.loads, (
        line for line in stdout.splitlines() if line.startswith("{"))) if "error" in r}
    assert "pass stage=0..4" in errors[1] and f"stage {N_CLASSES} out of range" in errors[4]
    assert set(errors) == {1, 3, 4}


def test_serve_cli_pipeline_equals_strict(strict_run, run_dirs, tmp_path, monkeypatch, capsys):
    out, _ = strict_run
    _serve(monkeypatch, run_dirs, tmp_path, "--pipeline", stdin=REQUESTS)
    lines = _lines(capsys)
    assert sorted(r["request"] for r in lines) == [0, 1, 2, 3, 4, 5]
    for i in (0, 2, 5):
        np.testing.assert_array_equal(np.load(tmp_path / f"signals_{i}.npy"),
                                      np.load(out / f"signals_{i}.npy"))


def test_serve_cli_oneshot_with_psd(run_dirs, tmp_path, monkeypatch, capsys, cond_svc):
    _serve(monkeypatch, run_dirs, tmp_path, "--oneshot", "--start", "3", "--stop", "8",
           "--stage", "4", "--guidance_scale", "1.5", "--psd")
    (line,) = _lines(capsys)
    assert line["request"] == 0 and line["n"] == 5 and line["last_windows_per_sec"] > 0
    sigs = np.load(tmp_path / "signals_0.npy")
    np.testing.assert_array_equal(sigs, cond_svc.sample(range(3, 8), stage=4,
                                                        guidance_scale=1.5))
    psds = np.load(tmp_path / "psds_0.npy")
    assert psds.shape[0] == 5 and np.isfinite(psds).all()


def test_serve_cli_stage_default_and_error(run_dirs, tmp_path, monkeypatch, capsys):
    """--stage sets the default of requests without one; a --guidance_scale
    on an unconditional checkpoint makes every request an error line."""
    _serve(monkeypatch, run_dirs, tmp_path, "--stage", "1",
           stdin=json.dumps({"seeds": [0]}) + "\n")
    assert _lines(capsys)[0]["n"] == 1
    _umbrella(monkeypatch, "serve", "--best_model_path", str(run_dirs / "aekl"),
              "--diffusion_path", str(run_dirs / "ldm"), "--output_dir", str(tmp_path / "u"),
              "--batch_size", "4", "--device", "cpu", "--guidance_scale", "2.0",
              stdin=json.dumps({"seeds": [0]}) + "\n")
    (line,) = _lines(capsys)
    assert "requires a class-conditional checkpoint" in line["error"]


@pytest.mark.parametrize("ldm,targets", [("ldm", "aekl,ldm,sampler,dpm"),
                                         ("cond_ldm", "aekl,sampler,dpm")],
                         ids=["unconditional", "conditional"])
def test_warm_cache_runs_every_target_on_the_cpu(run_dirs, monkeypatch, capsys, ldm, targets):
    cfg = run_dirs / ldm / "config.yaml"
    _umbrella(monkeypatch, "warm-cache", "--config_file", str(cfg), "--targets", targets,
              "--batch_sizes", "1,2", "--device", "cpu")
    labels = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()]
    steps = {"ldm": f"ddim-{STEPS}", "cond_ldm": f"ddim-{STEPS}"}[ldm]
    dpm = "dpm++2m-20" if ldm == "ldm" else f"dpm++2m-{STEPS}"
    want = ["warmed aekl train step batch 2"]
    if ldm == "ldm":
        want += ["warmed ldm train step batch 2"]
        want += [f"warmed {k} sampler batch {b}" for k in (steps, dpm) for b in (1, 2)]
    else:
        want += [f"warmed {k} {g}sampler batch {b}" for k in (steps, dpm)
                 for g in ("", "guided ") for b in (1, 2)]
    assert labels == want


def test_warm_cache_runs_the_ldm_target_of_a_conditional_config(run_dirs, monkeypatch,
                                                                 capsys):
    """The ldm target of a conditional config runs one labelled train step."""
    _umbrella(monkeypatch, "warm-cache", "--config_file",
              str(run_dirs / "cond_ldm" / "config.yaml"), "--targets", "ldm",
              "--device", "cpu")
    labels = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()]
    assert labels == ["warmed ldm train step batch 2"]


def test_warm_cache_refuses_the_ldm_target_of_a_conditional_config(run_dirs, monkeypatch):
    """What warm-cache still refuses, now that a conditional config's ldm
    target runs: an unknown target, before anything is built."""
    with pytest.raises(SystemExit, match="unknown targets"):
        _umbrella(monkeypatch, "warm-cache", "--config_file",
                  str(run_dirs / "cond_ldm" / "config.yaml"), "--targets", "ldm,bench",
                  "--device", "cpu")


def _sample_cli(monkeypatch, run_dirs, out, *flags):
    return _umbrella(monkeypatch, "sample", "--output_dir", str(out), "--best_model_path",
                     str(run_dirs / "aekl"), "--diffusion_path", str(run_dirs / "cond_ldm"),
                     "--sampler", "dpm++2m", "--num_inference_steps", str(STEPS),
                     "--start_seed", "0", "--stop_seed", "3", "--batch_size", "4",
                     "--no_psd", "--device", "cpu", *flags)


def test_sample_cli_stage_and_guidance(run_dirs, tmp_path, monkeypatch, cond_svc):
    _sample_cli(monkeypatch, run_dirs, tmp_path, "--stage", "2", "--guidance_scale", "2.0")
    out = tmp_path / "samples_ldm_1_no-spectral_edfx_stage2"
    got = np.stack([np.load(out / f"sample_{i}.npy")[0, 0] for i in range(3)])
    want = cond_svc.sample(range(3), stage=2, guidance_scale=2.0)[..., 0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flags,match", [((), "pass stage=0..4"),
                                         (("--stage", "7"), "stage 7 out of range")])
def test_sample_cli_refuses_a_bad_stage(run_dirs, tmp_path, monkeypatch, flags, match):
    with pytest.raises(SystemExit, match=match):
        _sample_cli(monkeypatch, run_dirs, tmp_path, *flags)
    assert not any(tmp_path.iterdir())
