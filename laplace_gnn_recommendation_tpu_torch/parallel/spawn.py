"""Run one function on N freshly spawned ranks joined by a ``file://``
rendezvous — the CPU stand-in for a ``torchrun`` launch (tests, the graft
dry run) and the way two ranks share one card over gloo.

No port is taken: the rendezvous is a file in a temporary directory, so
concurrent runs on one host never collide. Every rank's process is joined
with a timeout and killed if it outlives it.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.multiprocessing as mp


def _worker(rank: int, n: int, backend: str, rdzv: str, out_dir: str,
            fn: Callable, args: Sequence) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)   # n ranks share the host's cores
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(n)
    os.environ.setdefault("LOCAL_RANK", "0")
    result: Any
    try:
        dist.init_process_group(backend, init_method=f"file://{rdzv}", world_size=n, rank=rank)
        try:
            result = ("ok", fn(*args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _status(out_dir: str, rank: int):
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)[0]


def run_ranks(fn: Callable, n: int, args: Sequence = (), backend: str = "gloo",
              timeout: float = 600.0) -> List[Any]:
    """``fn(*args)`` on ``n`` spawned ranks of one process group; returns each
    rank's result in rank order. ``fn`` must be importable by name (a
    module-level function) and its result picklable. Raises with the failing
    rank's traceback if any rank fails, and on ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        rdzv = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker, args=(r, n, backend, rdzv, tmp, fn, args),
                             daemon=False) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # poll, so that one rank's failure ends the others at once (they
            # would wait in their next collective until the timeout)
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if not p.is_alive() and _status(tmp, r) != "ok"]
                if failed:
                    break
                if time.monotonic() > deadline:
                    late = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(f"ranks {late} still running after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        loaded = []
        for r in range(n):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    loaded.append(pickle.load(f))
            else:
                loaded.append(None)
        for r, res in enumerate(loaded):
            if res is not None and res[0] != "ok":
                raise RuntimeError(f"rank {r} failed:\n{res[1]}")
        for r, res in enumerate(loaded):
            if res is None:
                raise RuntimeError(f"rank {r} exited with code {procs[r].exitcode} and no result")
        return [res[1] for res in loaded]
