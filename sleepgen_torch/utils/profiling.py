"""Tracing and profiling, the port's counterpart of
``sleepgen/utils/profiling.py``.

``trace`` writes a ``torch.profiler`` trace (CPU and, where there is one,
CUDA activity) into a directory; ``flops_of`` counts a function's
floating-point operations with ``torch.utils.flop_counter``; ``time_step``
times a step with the card synchronised before each reading of the clock;
``device_memory_report`` gives each card's allocator statistics under the
JAX package's keys; ``enable_nan_debugging`` turns on autograd's anomaly
mode; ``maybe_initialize_multihost`` brings up ``torch.distributed`` from
torchrun's environment when ``SLEEPGEN_MULTIHOST=1``. The JAX package's
persistent compilation cache and its TPU contact line have no counterpart
(the kernels' library is the only build that outlives a process, and it
is cached by ``kernels/_build.py``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; the trace (TensorBoard's / Perfetto's JSON) is
    written into ``log_dir`` when it ends. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as p:
        yield p


def flops_of(fn: Callable, *args, **kwargs) -> Optional[float]:
    """Floating-point operations of one call of ``fn`` (a multiply-add
    counts two), or None if no operation it runs is counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total else None


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_step(fn: Callable, *args, iters: int = 10, warmup: int = 2,
              **kwargs) -> Dict[str, float]:
    """Seconds per call of ``fn`` over ``iters`` calls after ``warmup``,
    the card synchronised before each reading of the clock."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    return {"sec_per_step": dt, "steps_per_sec": 1.0 / dt}


def device_memory_report() -> Dict[str, Any]:
    """Per card: bytes held by tensors (``bytes_in_use``), the card's
    memory (``bytes_limit``) and their ratio in percent (``pct``). Empty
    without a card, as the JAX package's report is for devices without
    memory statistics."""
    report = {}
    if not torch.cuda.is_available():
        return report
    for i in range(torch.cuda.device_count()):
        in_use = torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)
        limit = torch.cuda.mem_get_info(i)[1]
        report[f"cuda:{i}"] = {"bytes_in_use": in_use, "bytes_limit": limit,
                               "pct": round(100 * in_use / max(limit, 1), 1)}
    return report


def enable_nan_debugging(enable: bool = True) -> None:
    """Autograd's anomaly mode: a backward pass that makes a NaN raises,
    naming the forward operation (slow; for localising spectral-loss
    blow-ups)."""
    torch.autograd.set_detect_anomaly(enable)


def maybe_initialize_multihost(device: str = "cuda") -> None:
    """``parallel.initialize_distributed`` from torchrun's environment when
    ``SLEEPGEN_MULTIHOST=1`` (NCCL for a CUDA ``device``, gloo for the
    CPU); the trainers' default mesh then spans every rank."""
    if os.environ.get("SLEEPGEN_MULTIHOST") == "1":
        import torch.distributed as dist

        from sleepgen_torch.parallel import initialize_distributed

        if not dist.is_initialized():
            initialize_distributed(device=device)
