"""The port's evaluation chain on the CPU, through ``python -m sleepgen_torch``:
``sample --sampler dpm++2m``, then ``compute-fid`` (synthetic against test,
and the test-vs-test floor), then ``compute-mmds`` in both modes, each
held to the JAX package's CLI on the same inputs and weights.

A synthetic ``.npy`` tree of 8 recordings of 35 s is the test split. The
AEKL ([4, 4, 8], latent 1) has numpy-drawn weights in a JAX tree, written
both as a JAX run dir (orbax ``best_model/``) and as a port run dir
(``params.npz``); the UNet (model_channels 16, channel_mult [1, 2], G 8,
latent 768, so samples are 3000 long) has seeded weights. USleep's weights
are the port's seeded ones, saved as a torch state dict that both CLIs
load (``--usleep_torch_params``), with and without a ``module.`` prefix.
"""
import csv
import sys

import numpy as np
import pytest
import torch

from sleepgen_torch.config import Config
from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree
from sleepgen_torch.utils import weights

from test_torch_port_parity import AEKL_CH, aekl_pair  # noqa: F401

N_SAMPLES = 4


def _config() -> Config:
    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = list(AEKL_CH)
    cfg.unet.model_channels, cfg.unet.channel_mult = 16, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.unet.image_size = 768
    return cfg


def _umbrella(monkeypatch, *argv):
    from sleepgen_torch.__main__ import main

    monkeypatch.setattr(sys, "argv", ["sleepgen_torch", *argv])
    return main()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, aekl_pair):
    """The test split, the AEKL as a JAX and a port run dir, the LDM as a
    port run dir, USleep's weights in two files, and the samples of
    ``sample --sampler dpm++2m --device cpu``."""
    from sleepgen.utils import CheckpointManager
    from sleepgen_torch.cli.compute_fid import load_usleep
    from sleepgen_torch.sample.sample_ldm import build_unet

    root = tmp_path_factory.mktemp("eval_cli")
    rows = write_synthetic_npy_tree(root / "npy", n_subjects=4, duration_s=35.0, seed=3)
    write_ids_csv(root / "ids_test.csv", rows)
    cfg = _config()
    _, ae_params, _ = aekl_pair
    for d in ("jax_aekl", "aekl", "ldm"):
        (root / d).mkdir()
        cfg.to_yaml(root / d / "config.yaml")
    ckpt = CheckpointManager(root / "jax_aekl")
    ckpt.save_best(ae_params)
    ckpt.close()
    weights.save_params_npz(root / "aekl" / "params.npz", {"params": ae_params})
    with torch.device("meta"):
        unet = build_unet(cfg, 1, 1)
    weights.save_params_npz(root / "ldm" / "params.npz",
                            {"params": weights.unet_state_to_jax(
                                weights.seeded_state_dict(unet, 7))})
    (root / "ldm" / "scale_factor.txt").write_text("1.5")

    sd = load_usleep(seed=4).state_dict()
    torch.save(sd, root / "usleep.pt")
    torch.save({f"module.{k}": v for k, v in sd.items()}, root / "usleep_module.pt")

    with pytest.MonkeyPatch.context() as mp:
        _umbrella(mp, "sample", "--output_dir", str(root / "samples"),
                  "--best_model_path", str(root / "aekl"), "--diffusion_path", str(root / "ldm"),
                  "--sampler", "dpm++2m", "--num_inference_steps", "3", "--start_seed", "0",
                  "--stop_seed", str(N_SAMPLES), "--batch_size", "2", "--device", "cpu")
    return root


def _data(root):
    return ["--path_test_ids", str(root / "ids_test.csv"),
            "--path_pre_processed", str(root / "npy")]


def test_sample_dpm_writes_the_artifact_contract(workspace):
    out = workspace / "samples" / "samples_ldm_1_no-spectral_edfx"
    for seed in range(N_SAMPLES):
        sample = np.load(out / f"sample_{seed}.npy")
        assert sample.shape == (1, 1, 3000) and np.isfinite(sample).all()
        psds, freqs, _ = np.load(out / f"psd_list_{seed}.npy", allow_pickle=True)
        assert psds.shape == (1, len(freqs)) and freqs.max() <= 18.0


def test_artifacts_hold_the_multitaper_psd(tmp_path):
    from sleepgen_torch.eval.psd import multitaper_psd_db
    from sleepgen_torch.sample.sample_ldm import write_sample_artifacts

    sig = np.random.default_rng(0).normal(size=(2, 3000, 1)).astype(np.float32)
    write_sample_artifacts(tmp_path, [5, 6], sig)
    np.testing.assert_array_equal(np.load(tmp_path / "sample_6.npy"), sig[1:].transpose(0, 2, 1))
    want, want_freqs = multitaper_psd_db(sig.transpose(0, 2, 1))
    psds, freqs, mean = np.load(tmp_path / "psd_list_6.npy", allow_pickle=True)
    np.testing.assert_array_equal(freqs, want_freqs)
    np.testing.assert_array_equal(psds, want[1])
    np.testing.assert_array_equal(mean, want[1].mean(axis=0))


@pytest.mark.parametrize("with_samples", [True, False], ids=["synthetic", "floor"])
def test_compute_fid_matches_jax(workspace, monkeypatch, capsys, with_samples):
    """The same reference-named USleep state dict in both CLIs: FID within
    rtol 1e-3 (features at the model bound, 302-wide covariances of 4-8
    windows), and the printed line is the JAX CLI's. On the floor, the
    same weights under a ``module.`` prefix give the same FID exactly,
    and the port's seeded weights (no file) a finite one."""
    from sleepgen.cli.compute_fid import main as jax_main
    from sleepgen_torch.cli.compute_fid import main

    root = workspace
    args = _data(root) + (["--sample_dir", str(root / "samples" / "samples_ldm_1_no-spectral_edfx")]
                          if with_samples else []) + ["--batch_size", "3"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _umbrella(monkeypatch, "compute-fid", *args)
    got = _umbrella(monkeypatch, "compute-fid", *args, "--usleep_torch_params",
                    str(root / "usleep.pt"), "--device", "cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    want = jax_main(args + ["--usleep_torch_params", str(root / "usleep.pt")])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line.split(":")[0] == jax_line.split(":")[0]
    assert np.isfinite(got) and got >= -1e-6
    np.testing.assert_allclose(got, want, rtol=1e-3)
    if not with_samples:
        assert main(args + ["--usleep_torch_params", str(root / "usleep_module.pt"),
                            "--device", "cpu"]) == got
        assert np.isfinite(main(args + ["--device", "cpu"]))


def _read_tsv(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh, delimiter="\t"))
    return rows[0], [r[0] for r in rows[1:]], np.array([float(r[1]) for r in rows[1:]])


@pytest.mark.parametrize("mode,atol", [("reconstruction", 2e-4), ("test_pairs", 1e-6)])
def test_compute_mmds_matches_jax(workspace, monkeypatch, tmp_path, mode, atol):
    """The TSV's name, columns and first column equal the JAX CLI's; the
    scores within ``atol``: 2e-4 through the AEKL (its reconstruction at
    the model bound), 1e-6 for the pairs (MS-SSIM alone, fp32)."""
    from sleepgen.cli.compute_mmds import main as jax_main

    root = workspace
    args = _data(root) + ["--mode", mode, "--batch_size", "3"]
    port = args + ["--best_model_path", str(root / "aekl"), "--output_dir", str(tmp_path / "port")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _umbrella(monkeypatch, "compute-mmds", *port)
    got_mean = _umbrella(monkeypatch, "compute-mmds", *port, "--device", "cpu")
    want_mean = jax_main(args + ["--best_model_path", str(root / "jax_aekl"),
                                 "--output_dir", str(tmp_path / "jax")])
    (got_file,), (want_file,) = (list((tmp_path / d).iterdir()) for d in ("port", "jax"))
    assert got_file.name == want_file.name
    got, want = _read_tsv(got_file), _read_tsv(want_file)
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[2]) == (8 if mode == "reconstruction" else 7)
    assert np.isfinite(got[2]).all()
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=atol)
    np.testing.assert_allclose(got_mean, want_mean, rtol=0, atol=atol)
