"""The port's host-side ingest against the JAX package's, on the CPU: the
EDF writer and reader, the FIR low-pass, FFT resampling, the sleep-period
crop, the SHHS stage map, and the ``convert-edfx``, ``convert-shhs`` and
``split-ids`` CLIs on the synthetic inputs of tests/test_convert_clis.py.
Everything is numpy on the host, so the bounds are tight: files byte for
byte, integers and text exactly, filters 1e-12.
"""
import csv
from pathlib import Path

import numpy as np
import pytest

from sleepgen.data import edf as jax_edf
from sleepgen.data import ingest as jax_ingest
from sleepgen_torch.data import edf, ingest


def _signals(sfreq=100, dur_s=300):
    t = np.arange(dur_s * sfreq) / sfreq
    return [80 * np.sin(2 * np.pi * 4 * t), 40 * np.sin(2 * np.pi * 9 * t),
            10 * np.sin(2 * np.pi * 0.3 * t)]


ANNS = [(0.0, 60.0, "Sleep stage W"), (60.0, 60.0, "Sleep stage 2"),
        (120.0, 60.0, "Sleep stage R"), (180.0, 120.0, "Sleep stage W")]
LABELS = ["EEG Fpz-Cz", "EEG Pz-Oz", "Resp oro-nasal"]


@pytest.mark.parametrize("annotations", [None, ANNS, ANNS * 40], ids=["plain", "tals", "long_tals"])
def test_write_edf_matches_jax_bytes(tmp_path, annotations):
    """The same file, byte for byte; ``long_tals`` needs an annotation
    record of several times the 64 bytes."""
    sig = _signals()
    edf.write_edf(tmp_path / "port.edf", sig, LABELS, 100, annotations)
    jax_edf.write_edf(tmp_path / "jax.edf", sig, LABELS, 100, annotations)
    assert (tmp_path / "port.edf").read_bytes() == (tmp_path / "jax.edf").read_bytes()


@pytest.mark.parametrize("include", [None, ["EEG Pz-Oz"]])
def test_read_edf_matches_jax(tmp_path, include):
    path = tmp_path / "rec.edf"
    jax_edf.write_edf(path, _signals(), LABELS, 100, ANNS)
    got, want = edf.read_edf(path, include), jax_edf.read_edf(path, include)
    assert got.header == want.header and got.annotations == want.annotations == ANNS
    assert (got.n_records, got.record_duration) == (want.n_records, want.record_duration)
    assert [vars(s) for s in got.signals] == [vars(s) for s in want.signals]
    assert got.labels == want.labels and [got.sfreq(i) for i in range(len(got.labels))] == [
        want.sfreq(i) for i in range(len(want.labels))]
    assert len(got.data) == len(want.data) == (3 if include is None else 1)
    for g, w in zip(got.data, want.data):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("h_freq,sfreq", [(18.0, 100.0), (18.0, 125.0), (30.0, 256.0)])
def test_lowpass_fir_matches_jax(h_freq, sfreq):
    x = np.random.default_rng(0).standard_normal(3000)
    np.testing.assert_allclose(ingest.lowpass_fir(x, h_freq, sfreq),
                               jax_ingest.lowpass_fir(x, h_freq, sfreq), rtol=0, atol=1e-12)


@pytest.mark.parametrize("src,dst", [(125.0, 100.0), (100.0, 100.0), (256.0, 100.0),
                                     (100.0, 128.0)])
def test_resample_fft_matches_jax(src, dst):
    x = np.random.default_rng(1).standard_normal(2999)
    got, want = ingest.resample_fft(x, src, dst), jax_ingest.resample_fft(x, src, dst)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("anns,mins", [(ANNS, 0.5), (ANNS, 30.0), ([(0.0, 30.0, "Sleep stage W")],
                                                                  30.0)],
                         ids=["half_minute", "half_hour", "no_sleep"])
def test_crop_to_sleep_period_matches_jax(anns, mins):
    x = np.arange(30000, dtype=np.float64)
    got, want = (m.crop_to_sleep_period(x, 100.0, anns, mins) for m in (ingest, jax_ingest))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_shhs_stage_map_matches_jax():
    labels = np.array([0, 1, 2, 3, 4, 5, 2, 0, 6])
    got, want = ingest.map_shhs_stages(labels), jax_ingest.map_shhs_stages(labels)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and ingest.SHHS_STAGE_MAP == jax_ingest.SHHS_STAGE_MAP


def _same_npy_trees(got: Path, want: Path) -> None:
    names = sorted(p.name for p in want.glob("*.npy"))
    assert names and sorted(p.name for p in got.glob("*.npy")) == names
    for name in names:
        g = np.load(got / name, allow_pickle=True)
        w = np.load(want / name, allow_pickle=True)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype == object:
            assert [tuple(r) for r in g] == [tuple(r) for r in w], name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_convert_edfx_cli_matches_jax(tmp_path):
    """tests/test_convert_clis.py's PSG (two EEG channels and a
    respiration one) and hypnogram, through both CLIs: the same files,
    equal arrays and annotations."""
    from sleepgen.cli.convert_edfx import main as jax_main
    from sleepgen_torch.cli.convert_edfx import main

    data = tmp_path / "edfx"
    data.mkdir()
    edf.write_edf(data / "SC4001E0-PSG.edf", _signals(), LABELS, 100)
    edf.write_edf(data / "SC4001EC-Hypnogram.edf", [np.zeros(1000)], ["Marker"], 100, ANNS)
    edf.write_edf(data / "SC4011E0-PSG.edf", _signals(dur_s=120), LABELS, 100, ANNS[:2])
    flags = ["--data_dir", str(data), "--crop_wake_mins", "0.5"]
    main(flags + ["--out_dir", str(tmp_path / "port")])
    jax_main(flags + ["--out_dir", str(tmp_path / "jax")])
    _same_npy_trees(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port").glob("*.npy"))) == 6


def test_convert_shhs_cli_matches_jax(tmp_path):
    """tests/test_convert_clis.py's SHHS inputs: a 125 Hz recording with
    profusion stages (N4 and REM among them), one with faulty labels, one
    missing; the same files and equal arrays."""
    from sleepgen.cli.convert_shhs import main as jax_main
    from sleepgen_torch.cli.convert_shhs import main

    sfreq, stages = 125, [0, 0, 2, 3, 4, 5, 2, 0, 0, 0]
    t = np.arange(len(stages) * 30 * sfreq) / sfreq
    c4, c3 = 60 * np.sin(2 * np.pi * 4 * t), 30 * np.sin(2 * np.pi * 7 * t)
    edf_dir, ann_dir = tmp_path / "edf", tmp_path / "ann"
    edf_dir.mkdir()
    ann_dir.mkdir()
    edf.write_edf(edf_dir / "shhs1-200001.edf", [c4, c3], ["EEG C4-A1", "EEG C3-A2"], sfreq)
    (ann_dir / "shhs1-200001-profusion.xml").write_text(
        "<CMPStudyConfig><SleepStages>"
        + "".join(f"<SleepStage>{s}</SleepStage>" for s in stages)
        + "</SleepStages></CMPStudyConfig>")
    edf.write_edf(edf_dir / "shhs1-200002.edf", [c4[:30 * sfreq]], ["EEG C4-A1"], sfreq)
    (ann_dir / "shhs1-200002-profusion.xml").write_text(
        "<CMPStudyConfig><SleepStages><SleepStage>9</SleepStage>"
        "</SleepStages></CMPStudyConfig>")
    ids = tmp_path / "ids.csv"
    ids.write_text("nsrrid\n200001\n200002\n200003\n")
    flags = ["--edf_dir", str(edf_dir), "--ann_dir", str(ann_dir), "--ids_csv", str(ids)]
    main(flags + ["--out_dir", str(tmp_path / "port")])
    jax_main(flags + ["--out_dir", str(tmp_path / "jax")])
    _same_npy_trees(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port").glob("*.npy"))) == 3


def _ids_csv(path: Path, subjects) -> Path:
    with open(path, "w", newline="") as fh:
        out = csv.writer(fh)
        out.writerow(["FILE_NAME_EEG", "subject", "night", "age", "gender", "LightsOff"])
        for i, s in enumerate(subjects):
            out.writerow([f"SC4{i:03d}E0-Fpz-Cz", s, 1 + i % 2, 30 + i, "F" if i % 3 else "M",
                          "22:00"])
    return path


@pytest.mark.parametrize("subjects", [[3, 3, 1, 7, 7, 2, 9, 4, 4, 5, 0, 8, 6, 6],
                                      ["s10", "s02", "s02", "a7", "s10", "b1", "c3", "d4"]],
                         ids=["integer_ids", "string_ids"])
def test_split_ids_cli_matches_jax(tmp_path, subjects):
    """The three split CSVs: the same text as the JAX CLI's pandas writes,
    rows in the same order, no subject in two splits."""
    from sleepgen.cli.split_ids import main as jax_main
    from sleepgen_torch.cli.split_ids import main

    for tag, fn in (("port", main), ("jax", jax_main)):
        d = tmp_path / tag
        d.mkdir()
        fn(["--ids_csv", str(_ids_csv(d / "ids.csv", subjects))])
    seen = set()
    for part in ("train", "valid", "test"):
        got = (tmp_path / "port" / f"ids_{part}.csv").read_text()
        assert got == (tmp_path / "jax" / f"ids_{part}.csv").read_text(), part
        split = {row["subject"] for row in csv.DictReader(got.splitlines())}
        assert split and not split & seen
        seen |= split
    assert seen == {str(s) for s in subjects}
