"""Profiling: a cProfile wrapper, ``torch.profiler`` traces and
speed-of-light accounting — the port of the JAX package's
``utils/profiling.py``.

The reference ships only the cProfile wrapper (``utils/profiling.py:5-26``).
:func:`device_trace` records the host and, where there is a card, its
kernels with ``torch.profiler`` and writes a Chrome trace;
:class:`Roofline` turns (bytes moved, operations, seconds) into shares of a
device's peak, by default one H100's published rates.
"""
from __future__ import annotations

import cProfile
import contextlib
import os
import pstats
import time
from dataclasses import dataclass
from typing import Optional

import torch


class Profiler:
    """cProfile wrapper, API-compatible with reference ``utils/profiling.py``."""

    def __init__(self, every: int = 20, dump_path: str = "stats.dmp"):
        self.profile = cProfile.Profile()
        self.every = every
        self.count = 0
        self.dump_path = dump_path

    def start(self) -> None:
        self.profile.enable()

    def stop(self) -> None:
        self.profile.disable()
        self.count += 1
        if self.count % self.every == 0:
            self.print_stats()

    def print_stats(self) -> None:
        self.profile.dump_stats(self.dump_path)
        stats = pstats.Stats(self.profile)
        stats.sort_stats("tottime").print_stats(8)


@contextlib.contextmanager
def device_trace(log_dir: str = "torch-trace"):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    where a card is present); writes ``<log_dir>/trace.json``, a Chrome
    trace (``chrome://tracing`` or Perfetto). Yields the profiler, whose
    ``key_averages()`` gives time by op or kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# One H100 SXM's published dense peaks (NVIDIA data sheet, at a 700 W limit):
# bf16 on the tensor cores, HBM3.
H100_PEAK_FLOPS_BF16 = 989e12
H100_PEAK_HBM_BYTES = 3.35e12


@dataclass
class Roofline:
    """Speed-of-light accounting for one kernel or section."""

    name: str
    seconds: float
    flops: float = 0.0
    bytes_moved: float = 0.0
    peak_flops: float = H100_PEAK_FLOPS_BF16
    peak_bytes: float = H100_PEAK_HBM_BYTES

    @property
    def achieved_flops(self) -> float:
        return self.flops / max(self.seconds, 1e-12)

    @property
    def achieved_bandwidth(self) -> float:
        return self.bytes_moved / max(self.seconds, 1e-12)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_moved, 1.0)

    @property
    def bound(self) -> str:
        ridge = self.peak_flops / self.peak_bytes
        return "compute" if self.arithmetic_intensity > ridge else "memory"

    @property
    def fraction_of_peak(self) -> float:
        """Share of the binding roof achieved."""
        if self.bound == "compute":
            return self.achieved_flops / self.peak_flops
        return self.achieved_bandwidth / self.peak_bytes

    def report(self) -> str:
        return (
            f"{self.name}: {self.seconds*1e3:.3f} ms, "
            f"{self.achieved_flops/1e12:.2f} TF/s, "
            f"{self.achieved_bandwidth/1e9:.1f} GB/s, "
            f"AI={self.arithmetic_intensity:.2f} ({self.bound}-bound), "
            f"{100*self.fraction_of_peak:.1f}% of speed-of-light"
        )


class Timer:
    """Wall-clock section timer. The card runs asynchronously: end a section
    that launched work with ``torch.cuda.synchronize()`` to time that work
    and not its enqueue."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
