"""A later PR adds a cell and a per-layer metric by adding files and
entries: in a copy of the benchmark, one new workload file and one new
metric file are found by name, with no code edited."""
import json
import shutil
import subprocess
import sys
import textwrap

from portbench import harness


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    man["workloads"].append({"name": "ldm-eeg.sample.ddim50-b128", "config": "ldm-eeg",
                             "traffic": "sample.ddim50-b128", "chips": 1, "why": "a test"})
    man["end_to_end"][2]["workloads"].append("ldm-eeg.sample.ddim50-b128")
    man["per_layer"].append({"name": "windows.per_batch", "unit": "windows", "better": "higher",
                             "source": "host_clock", "layer": "sample loop",
                             "moves": "sample_windows_per_s",
                             "workloads": ["ldm-eeg.sample.ddim50-b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    spec = {**harness.workload("ldm-eeg.sample.ddim200-b64"), "steps": 50, "batch": 128}
    (tmp_path / "portbench" / "workloads" / "ldm-eeg.sample.ddim50-b128.json").write_text(
        json.dumps(spec))
    (tmp_path / "portbench" / "metrics" / "windows.per_batch.py").write_text(textwrap.dedent('''
        def read(run):
            return run["record"]["batch"]
    '''))
    probe = textwrap.dedent('''
        import json, sys
        sys.path.insert(0, sys.argv[1])
        from portbench import harness
        man = harness.manifest()
        cell = "ldm-eeg.sample.ddim50-b128"
        per_layer = [m["name"] for m in harness.cell_metrics(man, cell, "per_layer")]
        e2e = [m["name"] for m in harness.cell_metrics(man, cell, "end_to_end")]
        value = harness.load_module("metrics", "windows.per_batch").read({"record": {"batch": 128}})
        print(json.dumps([str(harness.ROOT), harness.workload(cell)["steps"], per_layer, e2e, value]))
    ''')
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    root, steps, per_layer, e2e, value = json.loads(out.strip().splitlines()[-1])
    assert root == str(tmp_path) and steps == 50 and value == 128
    assert per_layer == ["windows.per_batch"]
    assert e2e == ["sample_windows_per_s", "setup_s"]
