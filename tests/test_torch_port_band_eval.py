"""The port's ``band-eval`` against the JAX CLI, on the CPU, in each of
its four modes with MS-SSIM and once with both metrics, on the workspace
of test_torch_port_reports.py (a synthetic split of 6 recordings, the
AEKL [4, 4, 8] as a JAX and a port run dir, 7 samples, USleep's seeded
weights as a torch state dict and as the JAX CLI's orbax checkpoint).
Bounds: MS-SSIM rtol 1e-4 (atol 2e-4 through the AEKL, its
reconstruction at the model bound), FID rtol 1e-3.
"""
import json

import numpy as np
import pytest
import torch

from test_torch_port_parity import aekl_pair  # noqa: F401
from test_torch_port_reports import N_WINDOWS, split, workspace  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode,metric", [("test_pairs", "ms_ssim"), ("sample_pairs", "ms_ssim"),
                                         ("sample_vs_test", "ms_ssim"),
                                         ("reconstruction", "ms_ssim"), ("test_pairs", "both")])
def test_band_eval_matches_jax(workspace, tmp_path, mode, metric):
    """The JSON's name and bands equal the JAX CLI's; each band's MS-SSIM
    mean and std within rtol 1e-4 (atol 2e-4 through the AEKL), FID within
    rtol 1e-3."""
    from sleepgen.cli.band_eval import main as jax_main
    from sleepgen_torch.cli.band_eval import main

    root = workspace
    flags = ["--mode", mode, "--metric", metric, "--path_test_ids", str(root / "ids.csv"),
             "--path_pre_processed", str(root / "npy"), "--sample_dir", str(root / "samples"),
             "--max_windows", str(N_WINDOWS)]
    got = main(flags + ["--output_dir", str(tmp_path / "port"), "--best_model_path",
                        str(root / "aekl"), "--usleep_torch_params", str(root / "usleep.pt"),
                        "--device", "cpu"])
    jax_main(flags + ["--output_dir", str(tmp_path / "jax"), "--best_model_path",
                      str(root / "jax_aekl"), "--usleep_checkpoint", str(root / "usleep_orbax")])
    name = f"band_eval_{mode}_{metric}_edfx.json"
    assert json.loads((tmp_path / "port" / name).read_text()) == got
    want = json.loads((tmp_path / "jax" / name).read_text())
    assert list(got) == list(want) == ["all", "delta", "theta", "alpha"]
    atol = 2e-4 if mode == "reconstruction" else 0.0
    for band, entry in want.items():
        assert set(got[band]) == set(entry)
        for k, v in entry.items():
            rtol = 1e-3 if k == "fid" else 1e-4
            np.testing.assert_allclose(got[band][k], v, rtol=rtol, atol=atol,
                                       err_msg=f"{band} {k}")
