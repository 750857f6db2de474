"""The port's reports and ``sample-ae`` against the JAX package, on the
CPU (``band-eval``: test_torch_port_band_eval.py, on this file's
workspace).

* The four report functions: their ``.npy`` dumps against the JAX
  functions' on the same arrays (rtol 1e-5: the port's Welch is float64
  numpy, the JAX one fp32), the PDFs written; with matplotlib hidden they
  raise ``ImportError`` as the JAX functions do, and the port's AEKL and
  LDM trainers still finish, printing the failure.
* ``sample-ae`` (and ``band-eval``) against the JAX CLIs on the same
  inputs and weights: a synthetic ``.npy`` tree of 6 recordings of 35 s;
  the AEKL ([4, 4, 8], latent 1, numpy-drawn weights of
  test_torch_port_parity's ``aekl_pair``) as a JAX run dir (orbax
  ``best_model/``) and a port run dir (``params.npz``); samples as
  ``sample_*.npy`` of (1, 1, 3000). Reconstructions at the model bound
  (rtol 2e-3 / atol 2e-4), MS-SSIM rtol 1e-4 (atol 2e-4 through the
  AEKL), FID rtol 1e-3 on USleep's seeded weights, which the port reads as
  a torch state dict and the JAX CLI as an orbax checkpoint of the same
  values (``import_usleep``).
"""
import sys

import numpy as np
import pytest
import torch

from sleepgen.eval import reports as jax_reports
from sleepgen_torch.config import Config
from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree
from sleepgen_torch.eval import reports
from sleepgen_torch.utils import weights

from test_torch_port_parity import AEKL_CH, aekl_pair  # noqa: F401

N_WINDOWS = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, n=2):
    rng = np.random.default_rng(seed)
    orig = rng.normal(size=(n, 1, 3000)).astype(np.float32)
    return orig, (orig + 0.1 * rng.normal(size=orig.shape)).astype(np.float32)


def test_reconstruction_figure_matches_jax(tmp_path):
    orig, recon = _pair()
    for tag, m in (("port", reports), ("jax", jax_reports)):
        (tmp_path / tag).mkdir()
        assert m.save_reconstruction_figure(tmp_path / tag, 5, orig, recon).exists()
    for name in ("original_RECONSTRUCTION_5.npy", "reconstr_RECONSTRUCTION_5.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))
    assert (tmp_path / "port" / "reconstruction_RECONSTRUCTION_5.pdf").exists()


@pytest.mark.parametrize("name,fmax", [("SPECTRAL_RECONSTRUCTION", 12.0),
                                       ("SAMPLE_VS_NOSCALE", 18.0)])
def test_spectral_figure_matches_jax(tmp_path, name, fmax):
    orig, recon = _pair(1, n=3)
    for tag, m in (("port", reports), ("jax", jax_reports)):
        (tmp_path / tag).mkdir()
        assert m.save_spectral_figure(tmp_path / tag, 2, orig, recon, name=name,
                                      fmax=fmax).name == f"compare_{name}_2.pdf"
    for prefix in ("original_spe", "reconstr_spe"):
        got = np.load(tmp_path / "port" / f"{prefix}_{name}_2.npy")
        want = np.load(tmp_path / "jax" / f"{prefix}_{name}_2.npy")
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sample_and_confusion_figures(tmp_path):
    _, recon = _pair(2, n=6)
    assert reports.save_sample_figure(tmp_path, 3, recon) == tmp_path / "ldm_samples_3.pdf"
    cm = np.array([[5, 1], [0, 4]])
    out = reports.save_confusion_matrix_figure(tmp_path / "cm.png", cm, ("A", "B"))
    assert out.exists() and out.stat().st_size > 0
    assert (tmp_path / "ldm_samples_3.pdf").stat().st_size > 0


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_reports_raise_without_matplotlib(tmp_path, no_matplotlib):
    orig, recon = _pair()
    calls = {"save_reconstruction_figure": (tmp_path, 0, orig, recon),
             "save_spectral_figure": (tmp_path, 0, orig, recon),
             "save_sample_figure": (tmp_path, 0, recon),
             "save_confusion_matrix_figure": (tmp_path / "cm.png", np.eye(5, dtype=int))}
    for name, args in calls.items():
        for m in (reports, jax_reports):
            with pytest.raises(ImportError):
                getattr(m, name)(*args)
    assert not any(tmp_path.iterdir())


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("reports")
    rows = write_synthetic_npy_tree(root / "npy", n_subjects=3, duration_s=35.0, seed=6)
    write_ids_csv(root / "ids.csv", rows)
    return root


def _tiny_config(out_dir, n_epochs: int) -> Config:
    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = list(AEKL_CH)
    cfg.discriminator.num_channels = 8
    cfg.unet.model_channels, cfg.unet.channel_mult = 16, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.diffusion.timesteps = 8
    cfg.train.n_epochs, cfg.train.batch_size, cfg.train.val_interval = n_epochs, 4, 1
    cfg.train.output_dir = str(out_dir)
    return cfg


@pytest.mark.parametrize("matplotlib", [True, False], ids=["figures", "no_matplotlib"])
def test_trainers_draw_figures_and_never_stop_for_them(split, tmp_path, request, capsys,
                                                       matplotlib):
    """One-epoch ``train_aekl`` and two-epoch ``train_ldm`` (an in-training
    sample at epoch 1) on the CPU: with matplotlib, the JAX trainers'
    figure files; without it, each trainer prints the failure and
    finishes with its best model."""
    from sleepgen_torch.data.dataset import load_split
    from sleepgen_torch.nn.aekl import AutoencoderKL
    from sleepgen_torch.train.train_aekl import train_aekl
    from sleepgen_torch.train.train_ldm import train_ldm

    if not matplotlib:
        request.getfixturevalue("no_matplotlib")
    ds = load_split(split / "ids.csv", split / "npy")
    aekl = train_aekl(_tiny_config(tmp_path, 1), ds, ds, device="cpu")
    with torch.device("meta"):
        ae = AutoencoderKL(num_channels=AEKL_CH)
    ldm = train_ldm(_tiny_config(tmp_path, 2), ds, ds, weights.lecun_normal_state(ae, 3),
                    device="cpu")
    out = capsys.readouterr().out
    aekl_dir, ldm_dir = tmp_path / aekl.run_dir, tmp_path / ldm.run_dir
    assert (aekl_dir / "best_model" / "params.npz").exists()
    assert (ldm_dir / "best_model" / "params.npz").exists()
    assert (ldm_dir / "sample_unconditioned_1.npy").exists()
    figures = [aekl_dir / "reconstruction_RECONSTRUCTION_0.pdf",
               aekl_dir / "compare_SPECTRAL_RECONSTRUCTION_0.pdf",
               ldm_dir / "ldm_samples_1.pdf", ldm_dir / "compare_SAMPLE_VS_NOSCALE_1.pdf"]
    if matplotlib:
        assert all(f.exists() for f in figures)
        assert (aekl_dir / "original_RECONSTRUCTION_0.npy").exists()
        assert "logging failed" not in out
    else:
        assert not any(f.exists() for f in figures)
        assert "figure logging failed at epoch 0" in out
        assert "sample figure logging failed at epoch 1" in out


# -- sample-ae and band-eval against the JAX CLIs -----------------------------------

@pytest.fixture(scope="module")
def workspace(split, aekl_pair):
    """The AEKL as a JAX and a port run dir, 6 samples, USleep's seeded
    weights as a torch state dict and as the JAX CLI's orbax checkpoint."""
    from sleepgen.utils import CheckpointManager
    from sleepgen.utils.torch_import import import_usleep
    from sleepgen_torch.cli.compute_fid import load_usleep

    root = split
    cfg = Config()
    cfg.dtype = "float32"
    cfg.aekl.num_channels = list(AEKL_CH)
    _, params, _ = aekl_pair
    for d in ("jax_aekl", "aekl"):
        (root / d).mkdir()
        cfg.to_yaml(root / d / "config.yaml")
    ckpt = CheckpointManager(root / "jax_aekl")
    ckpt.save_best(params)
    ckpt.close()
    weights.save_params_npz(root / "aekl" / "params.npz", {"params": params})
    (root / "samples").mkdir()
    rng = np.random.default_rng(8)
    for i in range(N_WINDOWS + 1):
        np.save(root / "samples" / f"sample_{i}.npy",
                rng.uniform(size=(1, 1, 3000)).astype(np.float32))
    sd = load_usleep(seed=5).state_dict()
    torch.save(sd, root / "usleep.pt")
    ckpt = CheckpointManager(root / "usleep_orbax")
    ckpt.save_best(import_usleep(sd, depth=12), name="usleep")
    ckpt.close()
    return root


def test_sample_ae_matches_jax(workspace, tmp_path):
    """The same batch files, (B, 1, 3072), at the model bound; the figure
    and its arrays beside the first batch."""
    from sleepgen.cli.sample_trials_autoencoder import main as jax_main
    from sleepgen_torch.cli.sample_trials_autoencoder import main

    root = workspace
    data = ["--path_train_ids", str(root / "ids.csv"), "--path_pre_processed", str(root / "npy"),
            "--batch_size", "4"]
    main(data + ["--output_dir", str(tmp_path / "port"), "--stage1_path", str(root / "aekl"),
                 "--device", "cpu"])
    jax_main(data + ["--output_dir", str(tmp_path / "jax"), "--stage1_path",
                     str(root / "jax_aekl"), "--no_figures"])
    tag = "-".join(map(str, AEKL_CH))
    got_dir, want_dir = tmp_path / "port" / "samples" / tag, tmp_path / "jax" / "samples" / tag
    names = sorted(p.name for p in want_dir.glob("synthetic_trial_eeg_*.npy"))
    assert names == ["synthetic_trial_eeg_0.npy", "synthetic_trial_eeg_1.npy"]
    for name in names:
        got, want = np.load(got_dir / name), np.load(want_dir / name)
        assert got.shape == want.shape and got.shape[1:] == (1, 3072)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert (got_dir / "reconstruction_RECONSTRUCTION_0.pdf").exists()
    np.testing.assert_array_equal(np.load(got_dir / "reconstr_RECONSTRUCTION_0.npy"),
                                  np.load(got_dir / names[0]))
