"""What every cell shares: finding a cell's files by name, the order of a
run (set-up, the timed window, the traced sub-window, the check against
the reference), the profiler's reading, and the result line.

A cell is ``portbench/workloads/<cell>.json``: its configuration
(``portbench/configs/<config>.json``), its driver
(``portbench/drivers/<driver>.py``) and its parameters. A per-layer metric
is ``portbench/metrics/<metric>.py``, whose ``read(run)`` returns a number
or None. ``BENCHMARK.json`` says which metrics each cell reports. Adding a
cell or a metric adds files and entries; no code here names one.

A driver module has ``setup(ctx) -> state``, ``window(ctx, state) -> dict``
(the timed window; ``metrics`` in it are the end-to-end values, the rest
is what the check and the readers need), ``profile(ctx, state)`` (the
traced sub-window), ``release(state)`` and ``check(ctx, record) ->
[(name, value, limit)]``, the numbers that decide ``correct``: each must
be at most its limit.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
# Top-level module names the benchmark's process must not hold: JAX and the
# JAX package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sleepgen")
# Device activity that occupies the card, by the trace's category
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BREAKDOWN_ENTRIES = 10
CACHE = ROOT / ".portbench-cache"  # every build and kernel cache of a run, inside the checkout


def prepare_process() -> None:
    """Before torch is imported: caches at fixed paths inside the checkout,
    and one host thread for the CPU's own work. The cells are host-bound
    where they are not card-bound, and a pool of spinning threads on a
    shared host makes the dispatching thread's pace vary from run to run."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    path = BENCH / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no cell {name!r}: {path.relative_to(ROOT)} does not exist")
    return read_json(path)


def config(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(man: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries of ``man`` that ``cell``
    reports: those listing it, and those without a list whose end-to-end
    metric (``moves``) the cell reports."""
    e2e = {m["name"] for m in cell_metrics_e2e(man, cell)}
    if kind == "end_to_end":
        return cell_metrics_e2e(man, cell)
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def cell_metrics_e2e(man: dict, cell: str) -> List[dict]:
    return [m for m in man["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def span(name: str):
    """A span of the harness's own, seen by the profiler."""
    import torch

    return torch.profiler.record_function(name)


def whole_batch_rate(t0: float, ends: List[float], sizes: List[int], seconds: float):
    """(items/s, batches counted) over the batches that finished inside the
    window [t0, t0 + seconds]: their items over the time from t0 to the last
    of them finishing. None if none finished."""
    done = [(e, n) for e, n in zip(ends, sizes) if e - t0 <= seconds]
    if not done:
        return None, 0
    return sum(n for _, n in done) / (max(e for e, _ in done) - t0), len(done)


# -- the profiler's reading ----------------------------------------------------

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_pct(trace: dict) -> float:
    """The share of the traced window in which no device event ran."""
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def device_seconds(trace: dict, names) -> float:
    """Device seconds of the events whose name contains one of ``names``."""
    return sum(e - s for n, s, e in trace["device_events"] if any(k in n for k in names))


def summarize_trace(trace: dict, window_span: str, span_names) -> dict:
    """From a Chrome trace of the profiler: device events (name, start,
    end in seconds from the window's start), the window's length, the seconds the device was busy (the union of its
    events), the device operations by total time and the longest idle
    gaps, each named by the innermost harness span the host was in."""
    events = trace.get("traceEvents", [])
    win = [e for e in events if e.get("name") == window_span and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [(e["name"], (e["ts"] - w0) * 1e-6, (e["ts"] + e.get("dur", 0) - w0) * 1e-6)
           for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    spans = [(e["name"], (e["ts"] - w0) * 1e-6, (e["ts"] + e["dur"] - w0) * 1e-6)
             for e in events if e.get("cat") == "user_annotation" and e["name"] in span_names]
    window_s = (w1 - w0) * 1e-6
    busy = _merge([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy)
    by_op: Dict[str, float] = {}
    for name, s, e in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    gaps, cursor = [], 0.0
    for s, e in busy + [[window_s, window_s]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)

    def host_in(t):
        inside = [(s, name) for name, s, e in spans if s <= t <= e]
        return max(inside)[1] if inside else "host"

    named = sorted(((host_in(0.5 * (s + e)), e - s) for s, e in gaps), key=lambda g: -g[1])
    return {"device_events": dev, "window_s": window_s, "busy_s": busy_s,
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES],
            "idle_gaps": [list(g) for g in named[:BREAKDOWN_ENTRIES]]}


def profile(fn: Callable[[], dict], device, span_names) -> dict:
    """Run ``fn`` under torch.profiler (host and card), the card
    synchronised at both ends, and summarise its trace; ``work`` is what
    ``fn`` returns, the work it ran. The trace is written under TMPDIR and
    removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with torch_profile(activities=activities) as prof:
        with span("profile.window"):
            work = fn()
            sync(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = read_json(Path(path))
    finally:
        os.unlink(path)
    return {**summarize_trace(trace, "profile.window", set(span_names)), "work": work}


# -- a run ---------------------------------------------------------------------

class Context:
    """What a driver needs: the cell's name, files and parameters, the run's
    arguments and the device."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device: str,
                 spec: Optional[dict] = None, cfg: Optional[dict] = None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.spec = spec if spec is not None else workload(cell)
        self.cfg = cfg if cfg is not None else config(self.spec["config"])
        self.reference = None  # the check's reference readings, for a control to reuse
        self.detail = {}  # per-window readings of the check and the controls


def run_cell(ctx: Context, started: float, man: Optional[dict] = None,
             driver: Optional[ModuleType] = None) -> dict:
    """One run of a cell: the result line's object, with the compared
    numbers under ``checks``. ``started`` is the host clock at the
    process's start (set-up is counted from it)."""
    import torch

    man = man if man is not None else manifest()
    driver = driver or load_module("drivers", ctx.spec["driver"])
    state = driver.setup(ctx)
    sync(ctx.device)
    setup_s = time.perf_counter() - started
    record = driver.window(ctx, state)
    trace = None
    if ctx.trace:
        trace = profile(lambda: driver.profile(ctx, state), ctx.device, driver.SPANS)
    cuda = torch.device(ctx.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.release(state)
    del state
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(ctx, record)
    values = {"setup_s": setup_s, **record["metrics"]}
    run = {"cell": ctx.cell, "spec": ctx.spec, "cfg": ctx.cfg, "record": record, "trace": trace}
    metrics = {}
    if ctx.trace:
        for m in cell_metrics(man, ctx.cell, "per_layer"):
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(man, ctx.cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(ctx.spec.get("chips", 1)), "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks) and record["failed"] == 0,
              "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": [list(kv) for kv in trace["device_ops"]],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result
