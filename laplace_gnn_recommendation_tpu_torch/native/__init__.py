"""ctypes bindings for the port's native sampler library (``sampler.cpp``,
the port's own copy of the JAX package's), compiled with ``g++`` at first
use into ``native/_build/<source-hash>/libsampler.so`` (git-ignored).

Nothing is built when the module is imported. :func:`lib` builds and loads
the library on its first call and returns ``None`` when no C++ toolchain can
build it; the sampler then runs its Python path and says so. ctypes releases
the GIL for the length of every call, which is what lets
``data.sampler.parallel_epoch_batches`` overlap its worker threads.

Bound here: ``nhop_sample``, ``assemble_train_batch``,
``common_items_matches``, ``pinsage_frontier`` and ``walk_step`` (JAX
``native/__init__.py:178-342``). :func:`run_sanitizer_check` builds the
library's source with the standalone driver ``sanitize_check.cpp`` under
ASAN+UBSAN or TSAN and runs it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "sampler.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_state: dict = {}   # "lib": the loaded CDLL or None once a build was tried


def library_path() -> str:
    """Where the build for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libsampler.so")


def _build() -> Optional[str]:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, text=True)
    except FileNotFoundError as e:
        print(f"[native] no C++ compiler ({e}); the samplers run their Python path")
        return None
    except subprocess.CalledProcessError as e:
        print(f"[native] g++ failed (rc {e.returncode}); the samplers run their "
              f"Python path:\n{e.stderr}")
        return None
    os.replace(tmp, so)   # atomic: a concurrent build finds a whole file
    return so


def _declare(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.nhop_sample.restype = ctypes.c_int64
    lib.nhop_sample.argtypes = [
        i64p, i32p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64,
        i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint64,
        i32p, i32p, ctypes.c_int64,
        i64p,
    ]
    lib.common_items_matches.restype = None
    lib.common_items_matches.argtypes = [
        i64p, i32p, i64p, i32p,
        i32p, ctypes.c_int64, ctypes.c_int32, i32p,
    ]
    lib.assemble_train_batch.restype = ctypes.c_int64
    lib.assemble_train_batch.argtypes = [
        i64p, i32p, i64p, i32p,
        ctypes.c_int64, ctypes.c_int64,
        i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64,
        ctypes.c_uint64,
        i32p, ctypes.c_int64,     # eval_cands [B, W], cand_width (0 = train)
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, u8p, u8p,
        i32p, i32p, u8p,
        i32p, i32p, f32p, u8p, i32p,
        i32p, i32p, i32p, i32p,
        i32p, i32p, i64p, i64p, ctypes.c_int64,
        i64p,
    ]
    lib.pinsage_frontier.restype = None
    lib.pinsage_frontier.argtypes = [
        i64p, i32p, i64p, i32p,
        i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint64,
        i32p, f32p,
    ]
    lib.walk_step.restype = None
    lib.walk_step.argtypes = [
        i64p, i32p, i64p, i32p,
        i32p, ctypes.c_int64, ctypes.c_uint64, i32p,
    ]


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; ``None`` when it cannot
    be built (the result of the first try is kept for the process)."""
    with _lock:
        if "lib" not in _state:
            so = _build()
            handle = None
            if so is not None:
                handle = ctypes.CDLL(so)
                _declare(handle)
            _state["lib"] = handle
        return _state["lib"]


def available() -> bool:
    return lib() is not None


_SANITIZE_FLAGS = {
    "asan": ["-fsanitize=address,undefined", "-fno-sanitize-recover=all"],
    # libgomp is not TSAN-instrumented (its fork-join hand-off reads as a
    # race on the capture struct); the TSAN build swaps the OpenMP regions
    # for the std::thread pool in sampler.cpp, which TSAN sees whole
    "tsan": ["-fsanitize=thread", "-DSAMPLER_STD_THREADS"],
}


def run_sanitizer_check(mode: str = "asan", timeout: float = 600.0) -> Tuple[bool, str]:
    """Build ``sampler.cpp`` + ``sanitize_check.cpp`` under a sanitizer and
    run the driver: the parallel BFS, repeated batch assembly over the shared
    generation-stamped scratch, the PinSAGE frontier and the walk step (JAX
    ``native/__init__.py:109-158``).

    ``mode``: ``asan`` (ASAN+UBSAN) or ``tsan`` (the parallel paths on the
    std::thread pool). Returns (ok, output). A standalone binary, not an
    LD_PRELOAD into Python, so the runtimes initialize cleanly and the
    threads run as in production."""
    flags = _SANITIZE_FLAGS[mode]
    exe = os.path.join(os.path.dirname(library_path()), f"sanitize_check_{mode}")
    os.makedirs(os.path.dirname(exe), exist_ok=True)
    cmd = ["g++", "-O1", "-g", "-fopenmp", "-fPIC", *flags, SOURCE,
           os.path.join(_DIR, "sanitize_check.cpp"), "-o", exe]
    build = subprocess.run(cmd, capture_output=True, text=True)
    if build.returncode != 0:
        return False, f"build failed:\n{build.stderr}"
    env = dict(os.environ)
    env.setdefault("ASAN_OPTIONS", "detect_leaks=1")
    env.setdefault("OMP_NUM_THREADS", "4")   # bounds TSAN's shadow memory
    run = subprocess.run([exe], capture_output=True, text=True, timeout=timeout, env=env)
    return run.returncode == 0, run.stdout + run.stderr


def _require() -> ctypes.CDLL:
    handle = lib()
    if handle is None:
        raise RuntimeError("the native sampler library could not be built")
    return handle


# Persistent slot/stamp scratch for assemble_train_batch, one set per live
# thread (garbage-collected with the thread). Generation stamping lets the C
# side skip the O(V) per-call clear: a slot entry is valid only when its
# stamp equals the call's generation, and concurrent workers stamp their own
# arrays.
_ASM_TLS = threading.local()


def _asm_scratch(num_users: int, num_items: int) -> dict:
    store = getattr(_ASM_TLS, "store", None)
    if store is None:
        store = _ASM_TLS.store = {}
    key = (num_users, num_items)
    sc = store.get(key)
    if sc is None:
        sc = store[key] = dict(
            uslot=np.empty(num_users, np.int32),
            islot=np.empty(num_items, np.int32),
            ustamp=np.zeros(num_users, np.int64),
            istamp=np.zeros(num_items, np.int64),
            gen=0,
        )
    sc["gen"] += 1  # unique per call; stamps start at 0 so gen starts at 1
    return sc


def _csr_args(user_row_ptr, user_cols, item_row_ptr, item_cols):
    return (np.ascontiguousarray(user_row_ptr, np.int64),
            np.ascontiguousarray(user_cols, np.int32),
            np.ascontiguousarray(item_row_ptr, np.int64),
            np.ascontiguousarray(item_cols, np.int32))


def nhop_sample(
    user_row_ptr: np.ndarray, user_cols: np.ndarray,
    item_row_ptr: np.ndarray, item_cols: np.ndarray,
    num_users: int, num_items: int,
    seeds: np.ndarray, n_hops: int, num_neighbors: int, rng_seed: int,
    max_edges_hint: int = 1 << 16,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch BFS → (src, dst, offsets). Grows the buffer on overflow."""
    handle = _require()
    csr = _csr_args(user_row_ptr, user_cols, item_row_ptr, item_cols)
    seeds = np.ascontiguousarray(seeds, np.int32)
    n = len(seeds)
    offsets = np.zeros(n + 1, np.int64)
    cap = max_edges_hint
    while True:
        src = np.empty(cap, np.int32)
        dst = np.empty(cap, np.int32)
        total = handle.nhop_sample(
            *csr, num_users, num_items,
            seeds, n, n_hops, num_neighbors,
            np.uint64(rng_seed & 0xFFFFFFFFFFFFFFFF),
            src, dst, cap, offsets,
        )
        if total >= 0:
            return src[:total], dst[:total], offsets
        cap *= 4


def assemble_train_batch(
    user_row_ptr, user_cols, item_row_ptr, item_cols,
    num_users: int, num_items: int,
    seeds: np.ndarray, n_hops: int, num_neighbors: int,
    pos_ratio: float, neg_ratio: float, k: int,
    id_max: int, total_edges: int, rng_seed: int,
    num_user_slots: int, num_item_slots: int, num_edges: int,
    labels_per_user: int, gt_per_user: int,
    eval_cands=None,
):
    """One native call → all padded batch arrays, or None when a budget
    would overflow (the caller then runs the Python path).

    ``eval_cands`` ([B, W] int32, -1 pads) switches the negatives to the
    eval semantics: matcher candidates XOR positives (count-one). ``None``
    = train (random negatives)."""
    handle = _require()
    seeds = np.ascontiguousarray(seeds, np.int32)
    b = len(seeds)
    if eval_cands is None:
        cand_arr = np.zeros((b, 1), np.int32)
        cand_width = 0
    else:
        cand_arr = np.ascontiguousarray(eval_cands, np.int32)
        if cand_arr.shape[0] != b:
            raise ValueError(f"eval_cands has {cand_arr.shape[0]} rows for {b} seeds")
        cand_width = cand_arr.shape[1]
    out = dict(
        user_ids=np.empty(num_user_slots, np.int32),
        item_ids=np.empty(num_item_slots, np.int32),
        user_mask=np.empty(num_user_slots, np.uint8),
        item_mask=np.empty(num_item_slots, np.uint8),
        edge_src=np.empty(num_edges, np.int32),
        edge_dst=np.empty(num_edges, np.int32),
        edge_mask=np.empty(num_edges, np.uint8),
        label_src=np.empty((b, labels_per_user), np.int32),
        label_dst=np.empty((b, labels_per_user), np.int32),
        label=np.empty((b, labels_per_user), np.float32),
        label_mask=np.empty((b, labels_per_user), np.uint8),
        label_item_global=np.empty((b, labels_per_user), np.int32),
        gt_items=np.empty((b, gt_per_user), np.int32),
        gt_count=np.empty(b, np.int32),
        seed_slots=np.empty(b, np.int32),
        seeds_out=np.empty(b, np.int32),
    )
    stats = np.zeros(1, np.int64)
    sc = _asm_scratch(num_users, num_items)
    rc = handle.assemble_train_batch(
        *_csr_args(user_row_ptr, user_cols, item_row_ptr, item_cols),
        num_users, num_items,
        seeds, b, n_hops, num_neighbors,
        float(pos_ratio), float(neg_ratio), int(k),
        int(id_max), int(total_edges),
        np.uint64(rng_seed & 0xFFFFFFFFFFFFFFFF),
        cand_arr, cand_width,
        num_user_slots, num_item_slots, num_edges,
        labels_per_user, gt_per_user,
        out["user_ids"], out["item_ids"], out["user_mask"], out["item_mask"],
        out["edge_src"], out["edge_dst"], out["edge_mask"],
        out["label_src"], out["label_dst"], out["label"],
        out["label_mask"], out["label_item_global"],
        out["gt_items"], out["gt_count"],
        out["seed_slots"], out["seeds_out"],
        sc["uslot"], sc["islot"], sc["ustamp"], sc["istamp"], sc["gen"],
        stats,
    )
    if rc != 0:
        return None
    out["label_truncations"] = int(stats[0])
    return out


def common_items_matches(
    user_row_ptr, user_cols, item_row_ptr, item_cols,
    users: np.ndarray, k: int,
) -> np.ndarray:
    """Batched collaborative 2-hop candidates, [B, k] int32 (-1 pads) — the
    native path of ``matchers.UsersWithCommonItemsMatcher``."""
    handle = _require()
    users = np.ascontiguousarray(users, np.int32)
    out = np.empty((len(users), k), np.int32)
    handle.common_items_matches(
        *_csr_args(user_row_ptr, user_cols, item_row_ptr, item_cols),
        users, len(users), int(k), out,
    )
    return out


def pinsage_frontier(
    user_row_ptr, user_cols, item_row_ptr, item_cols,
    seeds: np.ndarray, walk_length: int, restart_prob: float,
    num_walks: int, num_neighbors: int, rng_seed: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PinSAGE random-walk frontier: (src, dst, weights), int64 / int64 /
    f32, each seed's ``num_neighbors`` most-visited items with their visit
    counts, zero-weight pads removed."""
    handle = _require()
    seeds = np.ascontiguousarray(seeds, np.int32)
    n = len(seeds)
    out_src = np.empty(n * num_neighbors, np.int32)
    out_w = np.empty(n * num_neighbors, np.float32)
    handle.pinsage_frontier(
        *_csr_args(user_row_ptr, user_cols, item_row_ptr, item_cols),
        seeds, n, int(walk_length), float(restart_prob), int(num_walks), int(num_neighbors),
        np.uint64(rng_seed & 0xFFFFFFFFFFFFFFFF),
        out_src, out_w,
    )
    dst = np.repeat(seeds.astype(np.int64), num_neighbors)
    keep = out_w > 0
    return out_src[keep].astype(np.int64), dst[keep], out_w[keep]


def walk_step(
    user_row_ptr, user_cols, item_row_ptr, item_cols,
    items: np.ndarray, rng_seed: int,
) -> np.ndarray:
    """One item→user→item step per item, int64; dead ends and negative
    items give -1."""
    handle = _require()
    items = np.ascontiguousarray(items, np.int32)
    out = np.empty(len(items), np.int32)
    handle.walk_step(
        *_csr_args(user_row_ptr, user_cols, item_row_ptr, item_cols),
        items, len(items), np.uint64(rng_seed & 0xFFFFFFFFFFFFFFFF), out,
    )
    return out.astype(np.int64)
