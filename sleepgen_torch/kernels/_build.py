"""Builds the port's CUDA sources into one library and loads it with ctypes.

Every ``sleepgen_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source, all started together; the objects
are linked into one shared library with a plain C interface, at first
use, as ``sleepgen_torch/_build/sleepgen_torch_kernels-<hash>.so``. The
hash covers every source under ``csrc/`` and the compiler flags, so an
edited source builds anew and a stale library is never loaded. Nothing
here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIBRARY = "sleepgen_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
BUILD_TIMEOUT_S = 900

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ip = ctypes.POINTER(ctypes.c_int)  # an output int, passed as ctypes.byref(c_int)
# The library's C entry points: (argument types, result type).
SIGNATURES = {
    "sg_error_string": ([_i], ctypes.c_char_p),
    "sg_gn_scratch_floats": ([_i] * 4, _i),
    "sg_group_norm_silu_scratch_floats": ([_p, _p] + [_i] * 5, _i),
    "sg_group_norm_silu": ([_p] * 6 + [_i, _i, _i, _i, _f, _i, _i, _p, _ip], _i),
    "sg_group_norm_silu_bwd": ([_p] * 9 + [_i] * 6 + [_p, _ip], _i),
    "sg_gn_silu_conv3": ([_p] * 7 + [_i] * 5 + [_f, _i, _i, _p, _ip], _i),
    "sg_adaln_modulate": ([_p] * 7 + [_i] * 6 + [_p], _i),
    "sg_attention": ([_p] * 2 + [_i] * 4 + [_f, _p], _i),
}

_loaded: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the toolkit's default location."""
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of sleepgen_torch are compiled "
            "from sleepgen_torch/csrc at first use and need the CUDA toolkit "
            "(nvcc on PATH or at /usr/local/cuda/bin/nvcc)")
    return path


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{LIBRARY}-{h.hexdigest()[:16]}.so"


def _run(procs: Dict[str, subprocess.Popen]) -> Dict[str, str]:
    """Wait for every process; raise with its output if one failed."""
    logs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} (exit {proc.returncode}):\n{log}")
        logs[name] = log
    return logs


def build() -> Dict[str, str]:
    """Compile and link the library unless it is built already. Returns
    each source's compiler output (the ptxas register and shared-memory
    report), empty if nothing was built; raises with the compiler's output
    if a step fails."""
    out = library_path()
    if out.exists():
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"  # concurrent builds use their own files
    objects = {src.name: BUILD_DIR / f"{src.stem}.{tag}.o"
               for src in _sources() if src.suffix == ".cu"}
    tmp = BUILD_DIR / f"{tag}.so.tmp"

    def start(cmd):
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    procs = {}
    try:
        for name, obj in objects.items():
            procs[name] = start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                 str(CSRC_DIR / name)])
        logs = _run(procs)
        procs = {"link": start([nvcc, "-shared", "-o", str(tmp),
                                *map(str, objects.values())])}
        _run(procs)
        os.replace(tmp, out)  # atomic: concurrent builds race safely
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objects.values(), tmp):
            path.unlink(missing_ok=True)
    return logs


def load() -> ctypes.CDLL:
    """The kernels' library, built first if needed; loaded once per process."""
    global _loaded
    with _lock:
        if _loaded is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _loaded = lib
    return _loaded


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.sg_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
