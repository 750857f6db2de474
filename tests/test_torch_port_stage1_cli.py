"""The port's whole pipeline on the CPU, with no JAX run dir: stage 1, then
stage 2, then sampling, through ``python -m sleepgen_torch``.

A synthetic ``.npy`` tree and split CSVs from ``sleepgen_torch.data.synthetic``;
AEKL [4, 4, 8] against a PatchDiscriminator of 8 channels, float32,
batch 4, eval every epoch, two epochs; then a UNet of model_channels 16
(``test_torch_port_train_cli._config``) on that AEKL's ``best_model/``;
then ``sample`` from both run dirs. A second ``train-aekl`` call resumes
and appends one epoch, and a non-finite loss stops training with a finite
``final_model``.
"""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree
from sleepgen_torch.train.train_aekl import METRICS

from test_torch_port_train_cli import _config as ldm_config
from test_torch_port_train_cli import _finite_params

RUN = "aekl_eeg_no-spectral_edfx"


def _aekl_config(out_dir, n_epochs=2) -> Config:
    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = [4, 4, 8]
    cfg.discriminator.num_channels = 8
    cfg.train.n_epochs, cfg.train.batch_size, cfg.train.val_interval = n_epochs, 4, 1
    cfg.train.output_dir = str(out_dir)
    return cfg


def _args(root, config):
    return ["--config_file", str(root / config),
            "--path_train_ids", str(root / "ids_train.csv"),
            "--path_valid_ids", str(root / "ids_valid.csv"),
            "--path_pre_processed", str(root / "npy"), "--dtype", "float32"]


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
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_aekl")
    rows = write_synthetic_npy_tree(root / "npy", n_subjects=4, duration_s=35.0)
    write_ids_csv(root / "ids_train.csv", [r for r in rows if r["subject"] < 3])
    write_ids_csv(root / "ids_valid.csv", [r for r in rows if r["subject"] == 3])
    _aekl_config(root / "outputs").to_yaml(root / "aekl.yaml")
    return root


@pytest.fixture(scope="module")
def aekl_run(workspace):
    """One ``train-aekl --device cpu`` call through the umbrella CLI, after
    checking that the default device (the GPU) raises on this host."""
    from sleepgen_torch.__main__ import main as umbrella

    root = workspace
    with pytest.MonkeyPatch.context() as mp:
        if not torch.cuda.is_available():
            mp.setattr(sys, "argv", ["sleepgen_torch", "train-aekl", *_args(root, "aekl.yaml")])
            with pytest.raises(RuntimeError, match="no CUDA device"):
                umbrella()
        mp.setattr(sys, "argv", ["sleepgen_torch", "train-aekl", *_args(root, "aekl.yaml"),
                                 "--device", "cpu"])
        umbrella()
    return root / "outputs" / RUN


def _log(run, split):
    return [json.loads(line) for line in (run / f"metrics_{split}.jsonl").open()]


def test_train_aekl_then_train_ldm_then_sample(workspace, aekl_run, capsys):
    root, run = workspace, aekl_run
    for name in ("config.yaml", "metrics_train.jsonl", "metrics_val.jsonl", "checkpoints",
                 "best_model/config.yaml", "best_model/params.npz", "final_model/params.npz"):
        assert (run / name).exists(), name
    train_log = _log(run, "train")
    assert [r["step"] for r in train_log] == [0, 1]
    assert all(np.isfinite(r[k]) for r in train_log for k in (*METRICS, "seconds"))
    assert [r["step"] for r in _log(run, "val")] == [0, 1]
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "step_00000002.pt", "step_00000004.pt"]
    assert _finite_params(run / "best_model")
    assert not (run / "best_model" / "scale_factor.txt").exists()

    from sleepgen_torch.cli.sample_trials import main as sample_main
    from sleepgen_torch.cli.train_ldm import main as train_ldm_main

    ldm_config(root / "ldm_outputs", n_epochs=1).to_yaml(root / "ldm.yaml")
    best = run / "best_model"
    train_ldm_main(["--config_file", str(root / "ldm.yaml"),
                    "--autoencoderkl_config_file_path", str(best / "config.yaml"),
                    "--best_model_path", str(best), *_args(root, "ldm.yaml")[2:],
                    "--device", "cpu"])
    ldm = root / "ldm_outputs" / "ldm_eeg_no-spectral_edfx" / "best_model"
    assert (ldm / "scale_factor.txt").exists() and _finite_params(ldm)
    sample_main(["--output_dir", str(root / "samples"), "--best_model_path", str(best),
                 "--diffusion_path", str(ldm), "--start_seed", "0", "--stop_seed", "2",
                 "--num_inference_steps", "2", "--batch_size", "2", "--device", "cpu"])
    out = root / "samples" / "samples_ldm_1_no-spectral_edfx"
    for seed in (0, 1):
        sample = np.load(out / f"sample_{seed}.npy")
        assert sample.shape == (1, 1, 3000) and np.isfinite(sample).all()
    assert "wrote 2 samples" in capsys.readouterr().out


def test_second_call_resumes_and_appends_one_epoch(workspace, aekl_run, tmp_path):
    """A copy of the run dir, trained for three epochs: the call starts at
    epoch 2 from the step-4 checkpoint and logs that epoch only."""
    from sleepgen_torch.cli.train_autoencoderkl import main as train_main

    root = workspace
    shutil.copytree(aekl_run, tmp_path / RUN)
    cfg = _aekl_config(tmp_path, n_epochs=3)
    cfg.to_yaml(root / "aekl3.yaml")
    result = train_main(_args(root, "aekl3.yaml") + ["--device", "cpu"])
    run = tmp_path / RUN
    assert result.last_epoch == 2 and not result.stopped_on_nan
    assert [r["step"] for r in _log(run, "train")] == [0, 1, 2]
    assert [r["step"] for r in _log(run, "val")] == [0, 1, 2]
    assert (run / "checkpoints" / "step_00000006.pt").exists()
    ckpt = torch.load(run / "checkpoints" / "step_00000006.pt", weights_only=True)
    assert ckpt["step"] == 6 and set(ckpt) == {"step", "params_g", "opt_g", "params_d",
                                               "opt_d", "best_loss"}


def test_nonfinite_loss_stops_with_finite_final_model(workspace, monkeypatch):
    """From the second epoch's first step on, the G loss is NaN: training
    stops after that epoch, and final_model is the step-2 checkpoint's."""
    from sleepgen_torch.data.dataset import load_split
    from sleepgen_torch.train import train_aekl as A

    root = workspace
    real, calls = A.generator_losses, []

    def poisoned(*args, **kw):
        calls.append(1)
        recon, terms = real(*args, **kw)
        if len(calls) > 2:  # two steps an epoch
            terms["recons_loss"] = terms["recons_loss"] * float("nan")
        return recon, terms

    monkeypatch.setattr(A, "generator_losses", poisoned)
    result = A.train_aekl(_aekl_config(root / "nan_outputs", n_epochs=3),
                          load_split(root / "ids_train.csv", root / "npy"),
                          load_split(root / "ids_valid.csv", root / "npy"), device="cpu")
    run = root / "nan_outputs" / RUN
    assert result.stopped_on_nan and result.last_epoch == 1
    assert np.isfinite(result.best_loss)
    assert _finite_params(run / "final_model")
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_00000002.pt"]
    assert not np.isfinite(_log(run, "train")[-1]["g_loss"])
