"""The traced run's record: host spans from the benchmark's own files, and the
device's timeline from ``torch.profiler`` (CUDA activity: kernels, copies,
sets), on one clock.

Host spans are taken with ``time.perf_counter_ns``. The device's events are
moved onto that clock by a marker: right after a synchronise the harness
notes the host time and launches one short sleep kernel, whose start on the
device is then that host time plus the launch's latency (microseconds,
against gaps of milliseconds).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]

MARKER_CYCLES = 1000


class Spans:
    """Host spans (name, start_ns, end_ns) and counters, kept in memory."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []
        self.counters: Dict[str, float] = {}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    def add(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value


def union_length(intervals: Sequence[Interval], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi)."""
    total, cur_a, cur_b = 0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def idle_gaps(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, at = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def idle_share(intervals: Sequence[Interval], lo: int, hi: int) -> float:
    """Share of [lo, hi) in which nothing ran on the device, in %."""
    return 100.0 * (1.0 - union_length(intervals, lo, hi) / max(hi - lo, 1))


def open_span(spans: Sequence[Tuple[str, int, int]], t: int) -> str:
    """Name of the innermost host span open at ``t`` ("none" outside all)."""
    best, best_len = "none", None
    for name, a, b in spans:
        if a <= t < b and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


class DeviceTrace:
    """``with DeviceTrace(torch) as dt:`` profiles the device; afterwards
    ``dt.events`` holds (name, start_ns, end_ns) on the host clock."""

    def __init__(self, torch):
        self.torch = torch
        self.events: List[Tuple[str, int, int]] = []
        self._prof = None
        self._marker_host = None

    def __enter__(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._marker_host = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = self._collect()
        return False

    def _collect(self) -> List[Tuple[str, int, int]]:
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA":
                continue
            raw.append((e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns())))
        markers = [r for r in raw if "spin" in r[0].lower() or "sleep" in r[0].lower()]
        if not markers:
            raise RuntimeError("the device trace holds no marker kernel: cannot align clocks")
        marker = min(markers, key=lambda r: r[1])
        off = marker[1] - self._marker_host
        return [(n, a - off, b - off) for n, a, b in raw if (n, a, b) != marker]


def breakdown(events, spans, lo: int, hi: int, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in [lo, hi), and the
    longest idle gaps named by the host span open when each began."""
    by_name: Dict[str, int] = {}
    for n, a, b in events:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_name[n] = by_name.get(n, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps([(a, b) for _, a, b in events], lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[n, t / 1e9] for n, t in ops],
        "idle_gaps": [[open_span(spans, a), (b - a) / 1e9] for a, b in gaps],
    }
