"""The port's run export and profiling utilities, against the JAX
package's ``utils/export.py`` and ``utils/profiling.py`` on the CPU.

An export of either package loads in the other: the UNet (model_channels
32, channel_mult (1, 2), attention at ds 2, G 8, latent 64) exported by
one and loaded by the other gives the exporter's outputs at the model
bound of tests/test_torch_import.py (rtol 2e-3 / atol 2e-4). The tracer
of ``utils/profiling.py`` is tested in tests/test_torch_port_tracing.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleepgen.nn import UNet1d as JaxUNet
from sleepgen.utils import export as jax_export
from sleepgen.utils import jit_init
from sleepgen_torch.nn.unet1d import UNet1d
from sleepgen_torch.utils import profiling, weights
from sleepgen_torch.utils.export import (export_run, flatten_params, load_exported_params,
                                         unflatten_params)

from test_torch_port_parity import ATOL, LATENT, RTOL, UNET_KW, _randomize


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread in this module: its models are tiny,
    and the suite runs several worker processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unet():
    m = JaxUNet(num_groups=8, **UNET_KW)
    p = jit_init(m, jax.random.PRNGKey(0), jnp.zeros((2, LATENT, 1)),
                 jnp.zeros((2,), jnp.int32))["params"]
    return m, jax.device_get(_randomize(p, 80))


def _inputs():
    x = np.random.default_rng(1).normal(size=(2, LATENT, 1)).astype(np.float32)
    return x, np.array([17, 931], np.int32)


def _port_out(tree, x, t):
    pm = weights.load_numpy_state(UNet1d(num_groups=8, **UNET_KW).eval(),
                                  weights.unet_state_from_jax(tree))
    with torch.no_grad():
        out = pm(torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(t))
    return out.numpy().transpose(0, 2, 1)


def test_flatten_roundtrip():
    tree = {"a": {"b": np.ones(3), "c": torch.zeros(2)}, "d": np.arange(4.0)}
    flat = flatten_params(tree)
    assert set(flat) == {"a/b", "a/c", "d"}
    assert all(isinstance(v, np.ndarray) for v in flat.values())
    back = unflatten_params(flat)
    np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
    np.testing.assert_array_equal(back["a"]["c"], np.zeros(2))
    np.testing.assert_array_equal(back["d"], tree["d"])
    assert flat.keys() == jax_export.flatten_params(
        {"a": {"b": np.ones(3), "c": np.zeros(2)}, "d": np.arange(4.0)}).keys()


def test_export_run(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.yaml").write_text("a: 1")
    (run / "metrics_train.jsonl").write_text('{"step":0}\n')
    np.save(run / "sample_0.npy", np.zeros(3))
    (run / "notes.bin").write_bytes(b"x")

    params = {"layer": {"kernel": np.ones((2, 2))}}
    out = export_run(run, params=params, metrics={"fid": 1.5})
    manifest = json.loads((out / "manifest.json").read_text())
    assert out == run / "export"
    assert manifest["has_model"] and manifest["metrics"]["fid"] == 1.5
    assert manifest["artifacts"] == ["config.yaml", "metrics_train.jsonl", "sample_0.npy"]
    assert (out / "artifacts" / "sample_0.npy").exists()
    loaded = load_exported_params(out)
    np.testing.assert_array_equal(loaded["layer"]["kernel"], np.ones((2, 2)))
    bare = export_run(run, tmp_path / "bare")
    assert not json.loads((bare / "manifest.json").read_text())["has_model"]
    assert not (bare / "final_model.npz").exists()


def test_jax_export_loads_in_the_port(unet, tmp_path):
    jm, params = unet
    x, t = _inputs()
    out = jax_export.export_run(tmp_path, tmp_path / "export", params=params)
    got = _port_out(load_exported_params(out), x, t)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_port_export_loads_in_jax(unet, tmp_path):
    jm, params = unet
    x, t = _inputs()
    pm = weights.load_numpy_state(UNet1d(num_groups=8, **UNET_KW).eval(),
                                  weights.unet_state_from_jax(params))
    out = export_run(tmp_path, tmp_path / "export",
                     params=weights.unet_state_to_jax(pm.state_dict()))
    tree = jax_export.load_exported_params(out)
    want = np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(_port_out(params, x, t), want, rtol=RTOL, atol=ATOL)


def test_time_step_reports_rates():
    calls = []
    stats = profiling.time_step(lambda x: calls.append(x * 2.0), torch.ones(128, 128),
                                iters=5, warmup=1)
    assert len(calls) == 6
    assert stats["sec_per_step"] > 0
    assert np.isclose(stats["steps_per_sec"], 1.0 / stats["sec_per_step"])


def test_device_memory_report_on_the_cpu():
    rep = profiling.device_memory_report()
    assert isinstance(rep, dict)
    assert rep == {}  # no card: no device with allocator statistics


def test_trace_writes_into_its_dir(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    files = list(tmp_path.iterdir())
    assert files and all(f.suffix == ".json" for f in files)


def test_nan_debugging_and_multihost_switches(monkeypatch):
    profiling.enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    monkeypatch.delenv("SLEEPGEN_MULTIHOST", raising=False)
    profiling.maybe_initialize_multihost("cpu")
    assert not torch.distributed.is_initialized()
