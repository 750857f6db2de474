"""Tracing and profiling, the port's counterpart of
``sleepgen/utils/profiling.py``.

``trace`` writes a ``torch.profiler`` trace (CPU and, where there is one,
CUDA activity) into a directory; ``time_step`` times a step with the card
synchronised before each reading of the clock; ``device_memory_report``
gives each card's allocator statistics under the JAX package's keys;
``enable_nan_debugging`` turns on autograd's anomaly mode;
``maybe_initialize_multihost`` brings up ``torch.distributed`` from
torchrun's environment when ``SLEEPGEN_MULTIHOST=1``. The JAX package's
persistent compilation cache and its TPU contact line have no counterpart
(the kernels' library is the only build that outlives a process, and it
is cached by ``kernels/_build.py``).

The program's own tracer: ``span(name)`` marks a layer of the work (the
sampler's call, noise, steps, update and decode, the UNet's forward, the
DiT's forward, conditioning, attention, MLP, modulation and final layer,
the training step's phases, the service's enqueue and wait). A span records
only while a ``torch.profiler`` session records in this process, or
inside ``tracing()``; otherwise it costs one check of a flag. A recorded
span lands in the profiler's trace as a ``record_function`` annotation,
on the kernels' timeline, and in an in-memory list that ``spans()``
returns: its name, id, parent's id, trace id (the outermost open span's
id), its start and end on the host in nanoseconds on the profiler's clock
(``clock_ns``), and on a CUDA process its device milliseconds between two
CUDA events recorded on the current stream at its open and close (none
for a span opened while that stream captures a CUDA graph, which must not
hold them).

The counters' registry: each module ``register``s the counters it counts,
at 0, and ``count``s them at their sites. An always-on counter counts what
the card ran (launches, by form and, as keyed counts, by shape; K2's
re-layouts; the DDIM graphs' captures and replays); a traced one counts
only while the tracer records (host time, the DiT's forwards). A CUDA
graph's capture runs nothing: it takes back what it counted
(``take_back_counts``) and each replay adds that again (``add_counts``).
A traced twin (``register_twin``) gains what its always-on counter gains
while the tracer records, the replays' counts included.
``counters()`` reads the named counts, ``keyed(name)`` a keyed one, and
``reset()`` zeroes them all with the spans. A device tally (``tally``, the
MoE's rows per expert) is a keyed count that a layer adds as a tensor on
the card while the tracer records; it stays there until ``keyed`` reads
it, so the layer never waits for the card.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

# The clock of the profiler's own events: torch.profiler stamps them with
# c10::getTime(), CLOCK_REALTIME (through its approximate clock, converted
# back), and its Chrome trace gives them in microseconds after the trace's
# ``baseTimeNanoseconds``
clock_ns = time.time_ns
# Finished spans kept in memory; those past the cap are counted, not kept
MAX_SPANS = 65536

_forced = 0  # depth of open tracing() blocks
_records: List["_Span"] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()  # each thread's stack of open spans
# The counters: the always-on family's, by name or, for a keyed count,
# (name, key); the traced family's by name; each registered name's family
_counts: collections.Counter = collections.Counter()
_traced: collections.Counter = collections.Counter()
_families: Dict[str, collections.Counter] = {}
_twins: Dict[str, str] = {}  # an always-on counter -> its traced twin
_tallies: Dict[str, torch.Tensor] = {}  # device tallies not yet read, by name


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


def recording() -> bool:
    """Whether the tracer records: a torch.profiler session records in this
    process (``torch.profiler.profile`` sets autograd's flag while it
    records), or a ``tracing()`` block is open."""
    return bool(_forced or _autograd_profiler._is_profiler_enabled)


@contextlib.contextmanager
def tracing():
    """Record spans and the kernels' host time in the body without a
    profiler (blocks may nest)."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One recorded span; see ``span``."""

    __slots__ = ("name", "id", "parent", "trace", "start_ns", "end_ns", "device_ms",
                 "_annotation", "_events")

    def __init__(self, name: str):
        self.name, self.id = name, next(_ids)
        self.device_ms = self._annotation = self._events = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.trace = stack[0].id if stack else self.id
        stack.append(self)
        self.start_ns = clock_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
            # the annotation stamps its start inside that call
            self.start_ns = (self.start_ns + clock_ns()) // 2
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        global _dropped
        if self._events is not None:
            self._events[1].record()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _stack().pop()
        self.end_ns = clock_ns()
        if len(_records) < MAX_SPANS:
            _records.append(self)
        else:
            _dropped += 1
            self._events = None
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the body as the span ``name`` while
    the tracer records (``recording()``), and does nothing otherwise."""
    if _forced or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def spans() -> List[Dict[str, Any]]:
    """The finished spans in the order they closed: ``name``, ``id``,
    ``parent`` (None for a root), ``trace``, ``start_ns`` and ``end_ns``
    (``clock_ns``), and ``device_ms`` (None off CUDA), resolved here once
    the card has reached each span's close."""
    for r in _records:
        if r._events is not None:
            r._events[1].synchronize()
            r.device_ms = r._events[0].elapsed_time(r._events[1])
            r._events = None
    return [{"name": r.name, "id": r.id, "parent": r.parent, "trace": r.trace,
             "start_ns": r.start_ns, "end_ns": r.end_ns, "device_ms": r.device_ms}
            for r in _records]


def register(*names: str, traced: bool = False) -> None:
    """Add counters to the registry at 0: the always-on family's, or with
    ``traced`` the traced family's. A keyed count needs no registering."""
    family = _traced if traced else _counts
    for name in names:
        _families[name] = family
        family[name] += 0


def register_twin(name: str, twin: str) -> None:
    """Register the always-on counter ``name`` and its traced twin, which
    gains what ``name`` gains while the tracer records, a CUDA graph's
    replays included (``add_counts``), its capture not."""
    register(name)
    register(twin, traced=True)
    _twins[name] = twin


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def count(name: str, n: int = 1, key: Any = None) -> None:
    """Add ``n`` to the counter ``name``, or to its count of ``key``; to a
    traced counter only while the tracer records."""
    if name in _traced:
        if _forced or _autograd_profiler._is_profiler_enabled:
            _traced[name] += n
    else:
        _counts[name if key is None else (name, key)] += n
        if key is None and name in _twins and not _capturing():
            count(_twins[name], n)


def snapshot_counts() -> collections.Counter:
    """The always-on counts as they stand."""
    return _counts.copy()


def take_back_counts(before: collections.Counter) -> collections.Counter:
    """What the always-on counts gained since ``before``, taken back off
    them."""
    made = _counts - before
    _counts.clear()
    _counts.update(before)
    return made


def add_counts(made: collections.Counter, times: int = 1) -> None:
    """Add ``made`` (``take_back_counts``'s) ``times`` over, to the traced
    twins too."""
    for k, n in made.items():
        _counts[k] += times * n
        if k in _twins:
            count(_twins[k], times * n)


def counters() -> Dict[str, int]:
    """One snapshot of the registered counters, each at 0 until counted:
    the kernels' launches (``k1.launches`` to ``k4.launches``), K2's weight
    re-layouts (``k2.relayouts``), K1's and K3's launches by form
    (``k1.form.<form>``, ``k3.form.<form>``); while the tracer recorded,
    the nanoseconds from each wrapper's entry to its return, the launches
    and re-layouts they cover (``k1.host_ns``, ``k1.traced_launches``, ...,
    ``k2.traced_relayouts``); the DDIM loop's CUDA graphs captured and
    replayed, and replayed while the tracer recorded
    (``sampler.graph_captures``, ``sampler.graph_replays``,
    ``sampler.traced_graph_replays``); the DiT's forwards, their rows x
    tokens and its passes between half-blocks that ran K4, while the
    tracer recorded (``dit.forwards``, ``dit.tokens``,
    ``dit.fused_norms``); K5's launches, those made while the tracer
    recorded (``k5.launches``, ``k5.traced_launches``), and the attentions
    sent to SDPA that K5 would have taken but for their length or width
    (``k5.declined``); and ``spans.dropped``, the spans past
    ``MAX_SPANS``."""
    out = {k: n for k, n in _counts.items() if isinstance(k, str)}
    out.update(_traced)
    out["spans.dropped"] = _dropped
    return dict(sorted(out.items()))


def tally(name: str, values: torch.Tensor) -> None:
    """Add ``values`` (1-D, integer, on any device) to the keyed count
    ``name``, entry i to key i, while the tracer records and the stream
    captures no graph; the sum stays on the tensor's device until ``keyed``
    reads it."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    if values.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    held = _tallies.get(name)
    values = values.detach().to(torch.int64)
    _tallies[name] = values if held is None else held + values


def keyed(name: str) -> Dict[Any, int]:
    """The keyed count ``name``: {key: count}, as launches by shape; a
    device tally is read here (one wait for the card) and added in."""
    held = _tallies.pop(name, None)
    if held is not None:
        for i, n in enumerate(held.tolist()):
            _counts[(name, i)] += n
    return {k[1]: n for k, n in _counts.items() if isinstance(k, tuple) and k[0] == name}


def reset() -> None:
    """Forget the finished spans and the count of dropped ones, and zero
    every counter."""
    global _dropped
    _records.clear()
    _dropped = 0
    _tallies.clear()
    _counts.clear()
    _traced.clear()
    for name, family in _families.items():
        family[name] = 0


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
