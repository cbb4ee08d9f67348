"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/<hash>/lib<name>.so`` through ``nvcc`` for ``sm_90a`` (Hopper);
``<hash>`` covers every source and the flags, so an edited source builds
anew and an unchanged one is loaded as it is. All missing libraries are
compiled in parallel, one ``nvcc`` per source. Loading is lazy: importing
this module (or any module of the package) compiles nothing.

``launches`` counts, per kernel, the launches the wrappers made; a run sets
it to zero (``launches.clear()``) before the work it wants to account for.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("segsum", "sorted_sum", "topk", "topk_f32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: collections.Counter = collections.Counter()
build_log: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh")):
            h.update(fname.encode())
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, _source_hash(), f"lib{name}.so")


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all at once;
    returns the wall seconds per library compiled here (nothing for a
    library found built)."""
    nvcc = None
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    failed: List[str] = []
    seconds: Dict[str, float] = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so`` (built first if needed), with
    ``argtypes`` set from ``signatures`` at its first load and every restype
    ``c_int`` (``c_int64`` for ``*_bytes``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int64 if fn.endswith("_bytes") else ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {rc}")


def stream_ptr(device) -> int:
    """Handle of PyTorch's current stream on ``device`` (a Python int)."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
