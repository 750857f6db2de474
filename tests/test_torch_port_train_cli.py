"""``python -m sleepgen_torch train-ldm`` on the CPU, end to end, at tiny widths.

A synthetic ``.npy`` tree and split CSVs from ``sleepgen_torch.data.synthetic``;
a frozen AEKL [4, 4, 8] with numpy-drawn weights, as a port run dir; a UNet
of model_channels 16, float32, 20 diffusion timesteps (so the in-training
DDPM sample is 20 steps), batch 4, eval every epoch. The run writes its
run dir, the sample CLI reads ``best_model/``, a second call resumes from
the saved step, and a non-finite loss stops training with a finite
``final_model``.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.nn import AutoencoderKL as JaxAEKL
from sleepgen.utils import jit_init
from sleepgen_torch.config import Config
from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree
from sleepgen_torch.utils import weights

from test_torch_port_parity import _randomize

AEKL_CH = (4, 4, 8)


def _config(out_dir, n_epochs=2) -> Config:
    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = list(AEKL_CH)
    cfg.unet.model_channels, cfg.unet.channel_mult = 16, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.diffusion.timesteps = 20
    cfg.train.n_epochs, cfg.train.batch_size, cfg.train.val_interval = n_epochs, 4, 1
    cfg.train.output_dir = str(out_dir)
    return cfg


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
    root = tmp_path_factory.mktemp("train_ldm")
    rows = write_synthetic_npy_tree(root / "npy", n_subjects=4, duration_s=35.0)
    write_ids_csv(root / "ids_train.csv", [r for r in rows if r["subject"] < 3])
    write_ids_csv(root / "ids_valid.csv", [r for r in rows if r["subject"] == 3])
    ae_dir = root / "aekl"
    ae_dir.mkdir()
    cfg = _config(root / "outputs")
    cfg.to_yaml(ae_dir / "config.yaml")
    ja = JaxAEKL(num_channels=AEKL_CH, latent_channels=1)
    rng = jax.random.PRNGKey(0)
    params = _randomize(jit_init(ja, {"params": rng}, jnp.zeros((1, 256, 1)), rng)["params"], 50)
    weights.save_params_npz(ae_dir / "params.npz", {"params": params})
    cfg.to_yaml(root / "ldm.yaml")
    return root


def _args(root, config="ldm.yaml"):
    return ["--config_file", str(root / config),
            "--autoencoderkl_config_file_path", str(root / "aekl" / "config.yaml"),
            "--best_model_path", str(root / "aekl"),
            "--path_train_ids", str(root / "ids_train.csv"),
            "--path_valid_ids", str(root / "ids_valid.csv"),
            "--path_pre_processed", str(root / "npy"), "--dtype", "float32"]


def _finite_params(run_dir):
    with np.load(run_dir / "params.npz") as data:
        return all(np.isfinite(data[k]).all() for k in data.files)


def test_train_ldm_cli_trains_samples_and_resumes(workspace, monkeypatch, capsys):
    from sleepgen_torch.__main__ import main as umbrella

    root = workspace
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            umbrella_argv = ["sleepgen_torch", "train-ldm", *_args(root)]
            monkeypatch.setattr(sys, "argv", umbrella_argv)
            umbrella()  # the default device is the GPU
    monkeypatch.setattr(sys, "argv", ["sleepgen_torch", "train-ldm", *_args(root),
                                      "--device", "cpu"])
    umbrella()
    assert "run_dir=" in capsys.readouterr().out
    run = root / "outputs" / "ldm_eeg_no-spectral_edfx"
    for name in ("config.yaml", "metrics_train.jsonl", "metrics_val.jsonl",
                 "checkpoints", "best_model", "final_model", "sample_unconditioned_1.npy",
                 "sample_noscale_unconditioned_1.npy"):
        assert (run / name).exists(), name
    assert np.load(run / "sample_unconditioned_1.npy").shape == (1, 1, 3072)
    train_log = [json.loads(line) for line in (run / "metrics_train.jsonl").open()]
    assert [r["step"] for r in train_log] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in train_log)
    assert len((run / "metrics_val.jsonl").read_text().splitlines()) == 3  # eval first
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "step_00000002.pt", "step_00000004.pt"]
    assert (run / "best_model" / "scale_factor.txt").exists()
    assert _finite_params(run / "best_model")

    from sleepgen_torch.cli.sample_trials import main as sample_main

    sample_main(["--output_dir", str(root / "samples"), "--best_model_path", str(root / "aekl"),
                 "--diffusion_path", str(run / "best_model"), "--start_seed", "0",
                 "--stop_seed", "2", "--num_inference_steps", "2", "--batch_size", "2",
                 "--device", "cpu"])
    out = root / "samples" / "samples_ldm_1_no-spectral_edfx"
    for seed in (0, 1):
        sample = np.load(out / f"sample_{seed}.npy")
        assert sample.shape == (1, 1, 3000) and np.isfinite(sample).all()
        assert (out / f"psd_list_{seed}.npy").exists()

    cfg = Config.from_yaml(root / "ldm.yaml")
    cfg.train.n_epochs = 3
    cfg.to_yaml(root / "ldm3.yaml")
    from sleepgen_torch.cli.train_ldm import main as train_main

    train_main(_args(root, "ldm3.yaml") + ["--device", "cpu"])
    train_log = [json.loads(line) for line in (run / "metrics_train.jsonl").open()]
    assert [r["step"] for r in train_log] == [0, 1, 2]  # resumed at epoch 2
    assert (run / "checkpoints" / "step_00000006.pt").exists()


def test_nonfinite_loss_stops_with_finite_final_model(workspace, monkeypatch):
    """From the second training epoch on, the loss is NaN: training stops
    after that epoch, and final_model is the last finite checkpoint."""
    from sleepgen_torch.data.dataset import load_split
    from sleepgen_torch.train import train_ldm as T

    root = workspace
    real, calls = T.ldm_losses, []

    def poisoned(*args, **kw):
        calls.append(1)
        losses = real(*args, **kw)
        return losses * float("nan") if len(calls) > 4 else losses  # eval, 2 steps, eval

    monkeypatch.setattr(T, "ldm_losses", poisoned)
    cfg = _config(root / "nan_outputs", n_epochs=3)
    ae_state = weights.aekl_state_from_jax(weights.load_params_npz(root / "aekl" / "params.npz"))
    result = T.train_ldm(cfg, load_split(root / "ids_train.csv", root / "npy"),
                         load_split(root / "ids_valid.csv", root / "npy"), ae_state,
                         device="cpu")
    run = root / "nan_outputs" / "ldm_eeg_no-spectral_edfx"
    assert result.stopped_on_nan and result.last_epoch == 1
    assert np.isfinite(result.best_loss)
    assert _finite_params(run / "final_model")
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_00000002.pt"]
