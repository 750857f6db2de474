"""The port's two standing rules, checked on the CPU.

Imports: ``sleepgen_torch`` and ``chip_smoke.py`` import nothing of JAX
(jax, flax, optax, orbax) and nothing of the JAX package ``sleepgen``. An
AST walk checks the source, since this image's interpreter imports jax at
start-up and ``sys.modules`` cannot tell.

Device: entry points run on the GPU unless given ``device="cpu"``; with no
GPU they raise rather than fall back. The kernels' build raises a clear
error when the CUDA compiler is missing.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sleepgen"}
PORT_FILES = sorted((ROOT / "sleepgen_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_sleepgen(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_walk_covers_the_serving_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"sleepgen_torch/serve.py", "sleepgen_torch/cli/serve.py",
            "sleepgen_torch/cli/warm_cache.py", "chip_smoke.py"} <= names


PACKAGE = ROOT / "sleepgen_torch"


def _imports_under(path: Path, *packages: str):
    """The modules ``path`` imports from any of ``packages``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{alias.name}" for alias in node.names)
    return sorted(n for n in names if any(n == p or n.startswith(p + ".") for p in packages))


# The layers' seams: the tracer's registry is the lowest layer, K2's tile
# cache is K2's own, and the diffusion layer sits below the samplers
LAYER_RULES = {
    "profiling-imports-no-kernels-nn-or-sample": lambda: _imports_under(
        PACKAGE / "utils" / "profiling.py", "sleepgen_torch.kernels", "sleepgen_torch.nn",
        "sleepgen_torch.sample"),
    "only-k2-names-its-tile-cache": lambda: [
        str(p.relative_to(ROOT)) for p in PORT_FILES
        if "_tiles_cache" in p.read_text() and p != PACKAGE / "kernels" / "fused_resblock.py"],
    "diffusion-imports-no-sample": lambda: [
        (str(p.relative_to(ROOT)), _imports_under(p, "sleepgen_torch.sample"))
        for p in sorted((PACKAGE / "diffusion").glob("*.py"))
        if _imports_under(p, "sleepgen_torch.sample")],
}


@pytest.mark.parametrize("rule", sorted(LAYER_RULES))
def test_layers_keep_their_seams(rule):
    assert LAYER_RULES[rule]() == []


def test_import_walk_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom sleepgen.config import Config\n"
                   "import sleepgen_torch\nimportlib.import_module('flax.linen')\n")
    assert set(_imported_roots(src)) & FORBIDDEN == {"jax", "sleepgen", "flax"}


def _tiny_models(num_classes: int = 0):
    from sleepgen_torch.nn.aekl import AutoencoderKL
    from sleepgen_torch.nn.unet1d import UNet1d
    from sleepgen_torch.sample.sample_ldm import sampling_schedule
    from sleepgen_torch.config import Config

    unet = UNet1d(model_channels=16, channel_mult=(1, 2), attention_resolutions=(2,),
                  num_groups=8, num_classes=num_classes).eval()
    ae = AutoencoderKL(num_channels=(2, 2, 4)).eval()
    return unet, ae, sampling_schedule(Config())


def test_entry_points_default_to_the_gpu(tmp_path):
    from sleepgen_torch.config import Config
    from sleepgen_torch.sample.sample_ldm import make_ldm_sampler, sample_ldm_trials
    from sleepgen_torch.train.train_aekl import train_aekl
    from sleepgen_torch.train.train_ldm import train_ldm

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    unet, ae, sched = _tiny_models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ldm_sampler(unet, ae, sched, latent_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_ldm_trials(Config(), {}, {}, 1.0, "unused")
    cfg = Config()
    cfg.train.output_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ldm(cfg, None, None, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_aekl(cfg, None, None)
    assert not any(tmp_path.iterdir())  # raised before writing a run dir

    from sleepgen_torch.eval.fid import compute_fid, usleep_fid_features
    from sleepgen_torch.nn.usleep import USleep

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ldm_sampler(unet, ae, sched, latent_len=32, sampler="dpm++2m")
    cfg.diffusion.sampler = "dpm++2m"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_ldm_trials(cfg, {}, {}, 1.0, "unused")
    usleep = USleep(depth=4, input_size_s=2.555)
    windows = np.zeros((2, 1, 256), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        usleep_fid_features(usleep, windows)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_fid(usleep, windows, windows)
    feats = usleep_fid_features(usleep, windows, device="cpu")
    assert feats.shape == (2, usleep.bottom[0].out_channels)

    from sleepgen_torch.cli import sample_trials, serve, warm_cache
    from sleepgen_torch.serve import SamplerService

    aekl_dir, ldm_dir = _tiny_run_dirs(tmp_path / "runs", num_classes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplerService.from_run_dirs(aekl_dir, ldm_dir)
    dirs = ["--best_model_path", str(aekl_dir), "--diffusion_path", str(ldm_dir)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([*dirs, "--output_dir", str(tmp_path / "serve")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_cache.main(["--config_file", str(ldm_dir / "config.yaml"),
                         "--targets", "sampler"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_trials.main([*dirs, "--output_dir", str(tmp_path / "sample"), "--stage", "1"])
    assert not (tmp_path / "sample").exists()
    assert SamplerService.from_run_dirs(aekl_dir, ldm_dir, batch_size=2, device="cpu").sample(
        [0], stage=1).shape == (1, 4 * 32 - 72, 1)

    from sleepgen_torch.cli import band_eval, run_sleep_decode, sample_trials_autoencoder
    from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree
    from sleepgen_torch.nn.chambon import SleepStagerChambon2018
    from sleepgen_torch.train.decode import train_decoder

    x = np.zeros((2, 3000, 1), np.float32)
    y = np.zeros(2, np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_decoder(SleepStagerChambon2018(), (x, y), (x, y), n_epochs=1)
    (tmp_path / "staged").mkdir()
    np.save(tmp_path / "staged" / "r-Fpz-Cz.npy", np.zeros((1, 3000)))
    np.save(tmp_path / "staged" / "r-annotation.npy",
            np.array([(0.0, 30.0, "Sleep stage W")], dtype=object), allow_pickle=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sleep_decode.main(["--data_dir", str(tmp_path / "staged"), "--output_dir",
                               str(tmp_path / "decode")])
    rows = write_synthetic_npy_tree(tmp_path / "npy", n_subjects=1, duration_s=31.0)
    write_ids_csv(tmp_path / "ids.csv", rows)
    data = ["--path_pre_processed", str(tmp_path / "npy")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_trials_autoencoder.main(["--output_dir", str(tmp_path / "sample_ae"),
                                        "--stage1_path", str(aekl_dir), "--path_train_ids",
                                        str(tmp_path / "ids.csv"), *data])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        band_eval.main(["--mode", "test_pairs", "--path_test_ids", str(tmp_path / "ids.csv"),
                        *data, "--output_dir", str(tmp_path / "band_eval")])
    for d in ("decode", "sample_ae", "band_eval"):
        assert not (tmp_path / d).exists()


def _tiny_run_dirs(root: Path, num_classes: int):
    """Port run dirs of _tiny_models' widths with seeded weights, latent 32,
    one sampling step."""
    from sleepgen_torch.config import Config
    from sleepgen_torch.utils import weights

    unet, ae, _ = _tiny_models(num_classes)
    cfg = Config()
    cfg.aekl.num_channels = [2, 2, 4]
    cfg.unet.model_channels, cfg.unet.channel_mult = 16, [1, 2]
    cfg.unet.attention_resolutions, cfg.unet.norm_num_groups = [2], 8
    cfg.unet.num_classes, cfg.unet.image_size = num_classes, 32
    cfg.diffusion.num_inference_steps = 1
    for name, tree in (("aekl", weights.aekl_state_to_jax(weights.seeded_state_dict(ae, 0))),
                       ("ldm", weights.unet_state_to_jax(weights.seeded_state_dict(unet, 1)))):
        (root / name).mkdir(parents=True)
        cfg.to_yaml(root / name / "config.yaml")
        weights.save_params_npz(root / name / "params.npz", {"params": tree})
    (root / "ldm" / "scale_factor.txt").write_text("1.0")
    return root / "aekl", root / "ldm"


def _launches(*kernels):
    from sleepgen_torch.utils import profiling

    c = profiling.counters()
    return tuple(c[f"{k}.launches"] for k in kernels)


def test_cpu_device_runs_the_plain_versions():
    from sleepgen_torch.sample.sample_ldm import make_ldm_sampler

    unet, ae, sched = _tiny_models()
    before = _launches("k1", "k2")
    out = make_ldm_sampler(unet, ae, sched, latent_len=32, num_inference_steps=2,
                           device="cpu")(1.0, [0, 1])
    assert out.shape == (2, 4 * 32 - 72, 1) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert _launches("k1", "k2") == before


def test_cpu_training_step_runs_the_plain_versions():
    """One tiny stage-1 step on CPU tensors: every GroupNorm forward and
    backward runs its plain version, so no kernel launch is counted."""
    from sleepgen_torch.config import Config
    from sleepgen_torch.train import train_aekl as A

    cfg = Config()
    cfg.aekl.num_channels, cfg.discriminator.num_channels = [2, 2, 4], 4
    ae, disc, opt_g, opt_d = A.build_trainer(cfg, "cpu")
    before = _launches("k1", "k3", "k2")
    metrics = A.make_train_step(ae, disc, opt_g, opt_d, cfg)(torch.rand(2, 1, 64),
                                                             torch.randn(2, 1, 16))
    assert set(metrics) == set(A.METRICS)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(p.grad is not None for p in ae.parameters())
    assert _launches("k1", "k3", "k2") == before


def test_kernel_build_names_the_missing_compiler(monkeypatch, tmp_path):
    from sleepgen_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    assert _build.library_path().parent == tmp_path / "_build"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build").exists()


def test_import_walk_covers_the_dm_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"sleepgen_torch/train/train_dm.py", "sleepgen_torch/data/staging.py",
            "sleepgen_torch/cli/train_pure_ldm.py", "sleepgen_torch/cli/sample_trials_ddpm.py",
            "sleepgen_torch/cli/impute.py"} <= names


def test_dm_entry_points_default_to_the_gpu(tmp_path):
    """train_dm, sample_dm_trials, make_dm_sampler and the train-dm,
    sample-dm and impute CLIs (both modes) raise with no GPU unless told
    device="cpu", before they write anything."""
    from sleepgen_torch.cli import impute, sample_trials_ddpm, train_pure_ldm
    from sleepgen_torch.config import Config
    from sleepgen_torch.data.synthetic import write_ids_csv, write_synthetic_npy_tree
    from sleepgen_torch.sample.sample_ldm import make_dm_sampler, sample_dm_trials
    from sleepgen_torch.train.train_dm import train_dm

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    unet, _, sched = _tiny_models()
    cfg = Config()
    cfg.train.output_dir = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dm_sampler(unet, sched, signal_len=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_dm_trials(cfg, {}, tmp_path / "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_dm(cfg, None, None)
    cfg.to_yaml(tmp_path / "dm.yaml")
    rows = write_synthetic_npy_tree(tmp_path / "npy", n_subjects=1, duration_s=31.0)
    write_ids_csv(tmp_path / "ids.csv", rows)
    data = ["--path_train_ids", str(tmp_path / "ids.csv"), "--path_valid_ids",
            str(tmp_path / "ids.csv"), "--path_pre_processed", str(tmp_path / "npy")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_pure_ldm.main(["--config_file", str(tmp_path / "dm.yaml"), *data])
    assert not (tmp_path / "out").exists()

    aekl_dir, ldm_dir = _tiny_run_dirs(tmp_path / "runs", num_classes=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_trials_ddpm.main(["--diffusion_path", str(ldm_dir), "--output_dir",
                                 str(tmp_path / "samples")])
    np.save(tmp_path / "w.npy", np.zeros((1, 3000), np.float32))
    flags = ["--input", str(tmp_path / "w.npy"), "--output_dir", str(tmp_path / "fixed"),
             "--mask_start", "0", "--mask_len", "10", "--diffusion_path", str(ldm_dir)]
    for extra in ([], ["--best_model_path", str(aekl_dir)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            impute.main([*flags, *extra])
    assert not (tmp_path / "samples").exists() and not (tmp_path / "fixed").exists()


def test_import_walk_covers_the_decode_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"sleepgen_torch/{m}.py" for m in (
        "nn/chambon", "nn/deepsleepnet", "train/decode", "data/edf", "data/ingest",
        "data/splits", "eval/reports", "cli/run_sleep_decode", "cli/convert_edfx",
        "cli/convert_shhs", "cli/split_ids", "cli/sample_trials_autoencoder",
        "cli/band_eval")} <= names


def test_both_packages_have_the_same_commands():
    """``python -m sleepgen_torch`` answers to every command of ``python -m
    sleepgen``, each a module of the port."""
    from sleepgen.__main__ import COMMANDS as JAX_COMMANDS
    from sleepgen_torch.__main__ import COMMANDS

    assert set(COMMANDS) == set(JAX_COMMANDS)
    for name, module in COMMANDS.items():
        assert module == JAX_COMMANDS[name].replace("sleepgen.", "sleepgen_torch.", 1)
        assert (ROOT / (module.replace(".", "/") + ".py")).exists()


def test_import_walk_covers_the_v1_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"sleepgen_torch/{m}.py" for m in (
        "diffusion/ddpm_v1", "nn/aekl_v1", "nn/discriminator", "nn/quant",
        "train/train_v1")} <= names


def test_v1_entry_points_default_to_the_gpu(tmp_path):
    """The v1 trainers, the v1 encoder state and quantized sampling raise with
    no GPU unless told device="cpu", before they write anything."""
    from sleepgen_torch.config import Config
    from sleepgen_torch.data.dataset import WindowDataset
    from sleepgen_torch.data.synthetic import make_synthetic_dataset
    from sleepgen_torch.nn.aekl_v1 import AutoencoderKLV1
    from sleepgen_torch.nn.discriminator import DiscriminatorV1
    from sleepgen_torch.sample.sample_ldm import make_ldm_sampler, sample_ldm_trials
    from sleepgen_torch.train import train_v1 as V

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    ds = WindowDataset.from_raw(make_synthetic_dataset(2, duration_s=30.0), window=248, pad=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.train_v1_encoder(ds, ds, tmp_path / "enc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.train_v1_ddpm(ds, {}, tmp_path / "ddpm", AutoencoderKLV1(resolution=256))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.init_v1_encoder_state(AutoencoderKLV1(n_channels=4, ch_mult=(1,), num_groups=4),
                                DiscriminatorV1(ndf=4), seed=0)
    assert not any(tmp_path.iterdir())
    unet, ae, sched = _tiny_models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ldm_sampler(unet, ae, sched, latent_len=32, quantized=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_ldm_trials(Config(), {}, {}, 1.0, tmp_path / "q", quantized=True)
    assert not (tmp_path / "q").exists()
    out = make_ldm_sampler(unet, ae, sched, latent_len=32, num_inference_steps=2,
                           device="cpu", quantized=True)(1.0, [0, 1])
    assert out.shape == (2, 4 * 32 - 72, 1) and bool(torch.isfinite(out).all())


# Modules of the JAX package the port has no file for, each with its reason.
LEFT_OUT = {
    "pallas_kernels/": "the TPU kernels: each has a hand-written CUDA counterpart, "
                       "kernels/ and csrc/ (K1, K2, K3; PERF.md section 6)",
    "utils/initutil.py": "jit_init, one jitted flax init graph: port modules initialise "
                         "in torch, and its trainers draw initial weights with numpy "
                         "(utils/weights.py)",
    "utils/torch_export.py": "the JAX package's export to torch names: the port's "
                             "utils/weights.py maps the same names",
    "utils/torch_import.py": "the JAX package's import from torch state dicts, which "
                             "needs JAX: the port's utils/weights.py maps the same names",
    "diffusion/inferer.py": "no caller outside the JAX package's tests (ROADMAP A)",
    "nn/blockwise_attention.py": "jnp online-softmax attention for long windows: the port "
                                 "keeps its kv_block_size contract (layers.check_kv_block) "
                                 "and computes one scaled_dot_product_attention at those "
                                 "lengths, past K5's longest row (kernels/attention.py)",
    "nn/fused_norm.py": "jnp GroupNorm with a custom VJP: its math is K1 and K3's plain "
                        "versions, held to fused_norm._bwd in test_torch_port_backward.py",
    "data/native/": "host C++ window gather: the port gathers with numpy, which gives "
                    "the same windows, as the JAX package's fallback does "
                    "(sleepgen/data/dataset.py:81-89); a speed item (ROADMAP A.S)",
}


def test_import_walk_covers_the_last_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"sleepgen_torch/{m}.py" for m in (
        "parallel/__init__", "parallel/mesh", "utils/export", "utils/profiling")} <= names


def test_every_jax_module_has_a_counterpart_or_a_reason():
    """The port is complete: every module of ``sleepgen/`` (and its native
    code) has a file of the same path in ``sleepgen_torch/`` or stands in
    ``LEFT_OUT`` with its reason; no entry of ``LEFT_OUT`` is stale."""
    jax_pkg, port = ROOT / "sleepgen", ROOT / "sleepgen_torch"
    modules = sorted(str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*")
                     if p.suffix in (".py", ".cpp") and "__pycache__" not in p.parts)
    missing = [m for m in modules if not (port / m).exists()
               and not any(m == k or (k.endswith("/") and m.startswith(k)) for k in LEFT_OUT)]
    assert not missing, f"no counterpart and no stated reason: {missing}"
    for k in LEFT_OUT:
        assert (jax_pkg / k).exists(), f"stale entry {k}"
        assert not (port / k).exists(), f"{k} has a counterpart now"
    assert (port / "kernels" / "group_norm.py").exists()
    assert (port / "kernels" / "fused_resblock.py").exists()
