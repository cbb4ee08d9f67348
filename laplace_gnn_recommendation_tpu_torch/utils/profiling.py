"""Profiling: a cProfile wrapper, ``torch.profiler`` traces,
speed-of-light accounting and the program's own spans and counters — the
port of the JAX package's ``utils/profiling.py``.

The reference ships only the cProfile wrapper (``utils/profiling.py:5-26``).
:func:`device_trace` records the host and, where there is a card, its
kernels with ``torch.profiler`` and writes a Chrome trace;
:class:`Roofline` turns (bytes moved, operations, seconds) into shares of a
device's peak, by default one H100's published rate for the work's dtype;
:data:`tracer` records named spans and counters at the program's layer
boundaries while it is enabled, on the host clock of
``time.perf_counter_ns``.
"""
from __future__ import annotations

import cProfile
import contextlib
import itertools
import os
import pstats
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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


# One H100 SXM's published dense peaks (NVIDIA data sheet, at a 700 W limit),
# operations a second by the dtype of the work: f32 outside the tensor cores,
# TF32, bf16 and int8 on them; HBM3.
H100_PEAK_FLOPS = {
    torch.float32: 67e12,
    "tf32": 495e12,
    torch.bfloat16: 989e12,
    torch.int8: 1979e12,
}
H100_PEAK_FLOPS_BF16 = H100_PEAK_FLOPS[torch.bfloat16]
H100_PEAK_HBM_BYTES = 3.35e12


@dataclass
class Roofline:
    """Speed-of-light accounting for one kernel or section. ``peak_flops``
    defaults to the H100's rate for ``dtype`` (``H100_PEAK_FLOPS``: a
    ``torch.dtype``, or ``"tf32"``)."""

    name: str
    seconds: float
    flops: float = 0.0
    bytes_moved: float = 0.0
    peak_flops: Optional[float] = None
    peak_bytes: float = H100_PEAK_HBM_BYTES
    dtype: object = torch.float32

    def __post_init__(self):
        if self.peak_flops is None:
            if self.dtype not in H100_PEAK_FLOPS:
                raise ValueError(f"no H100 peak for dtype {self.dtype!r}; pass peak_flops")
            self.peak_flops = H100_PEAK_FLOPS[self.dtype]

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


@dataclass
class Span:
    """One finished span of :data:`tracer`. ``start`` and ``end`` are
    ``time.perf_counter_ns`` readings; ``thread`` is the native id of the
    thread that ran it; ``parent`` is the innermost span open on that thread
    at its start and ``root`` the outermost (its own id when none was open),
    so every span of one server batch shares one ``root``. A device span's
    ``device_start`` and ``device_end`` are the times its stream reached its
    entry and its exit, put on the same host clock by :meth:`Tracer.drain`
    (None without a card)."""

    name: str
    start: int
    end: int
    thread: int
    id: int
    parent: Optional[int]
    root: int
    device: bool = False
    device_start: Optional[int] = None
    device_end: Optional[int] = None


# what ``Tracer.span`` returns while the tracer is off: no clock read, no
# event, nothing allocated
NULL_SPAN = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("_tracer", "_name", "_device", "_frame", "_start", "_ev0", "_recording")

    def __init__(self, tracer: "Tracer", name: str, device: bool):
        self._tracer, self._name, self._device = tracer, name, device

    def __enter__(self):
        tr = self._tracer
        try:
            stack, tid = tr._local.state
        except AttributeError:
            stack, tid = tr._local.state = ([], threading.get_native_id())
        sid = next(tr._ids)
        # a frame: (id, root, parent, thread, the thread's stack)
        self._frame = (sid, stack[-1][1], stack[-1][0], tid, stack) if stack else \
            (sid, sid, None, tid, stack)
        stack.append(self._frame)
        self._recording = tr._recording
        self._ev0 = None
        if self._device and tr._anchor is not None:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        self._start = time.perf_counter_ns()

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        ev1 = None
        if self._ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        sid, root, parent, tid, stack = self._frame
        stack.pop()
        tr = self._tracer
        done = (self._name, self._start, end, tid, sid, parent, root, self._device, self._ev0, ev1)
        with tr._lock:
            # a span that ends after disable(), or in a later recording, is dropped
            if tr.on and tr._recording == self._recording:
                tr._done.append(done)
        return False


class Tracer:
    """The program's spans and counters, kept in memory; off until
    :meth:`enable`.

    ``with tracer.span(name):`` marks a phase on the calling thread;
    ``device=True`` also records a CUDA event on the current stream at its
    entry and exit (nothing waits for them inside the span).
    ``tracer.count(name, n)`` adds ``n`` to a counter. Off, ``span`` returns
    the shared :data:`NULL_SPAN` and ``count`` returns at once; a call site
    that must compute a counter's value does so under ``if tracer.on``.

    :meth:`enable` starts a fresh recording: where there is a card it
    synchronises, notes the host time and records an anchor event.
    :meth:`drain` synchronises once, puts every device span's events on the
    host clock (anchor host time + ``anchor.elapsed_time(event)``) and hands
    over what was recorded; :meth:`disable` stops recording. A span is kept
    only if it ends while the recording it started in is on: one still open
    at :meth:`disable` (a prefetch worker's, say) is dropped when it ends."""

    def __init__(self):
        self.on = False
        self._local = threading.local()
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._done: List[tuple] = []   # finished spans, as plain tuples until drained
        self._counters: Dict[str, float] = {}
        self._anchor: Optional[tuple] = None
        self._recording = 0   # counts calls of enable()

    def span(self, name: str, device: bool = False):
        if not self.on:
            return NULL_SPAN
        return _OpenSpan(self, name, device)

    def count(self, name: str, n: float = 1) -> None:
        if not self.on:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def enable(self) -> None:
        with self._lock:
            self._done, self._counters = [], {}
            self._recording += 1
        self._anchor = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            host = time.perf_counter_ns()
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            self._anchor = (host, anchor)
        self.on = True

    def disable(self) -> None:
        with self._lock:
            self.on = False

    def drain(self) -> Tuple[List[Span], Dict[str, float]]:
        """(spans finished since :meth:`enable` or the last drain, in the
        order they ended; counters), and forgets them. Spans still open are
        not in it, and are dropped if they end after :meth:`disable`."""
        with self._lock:
            done, self._done = self._done, []
            counters, self._counters = self._counters, {}
        if self._anchor is not None:
            torch.cuda.synchronize()
        spans = []
        for name, start, end, tid, sid, parent, root, device, ev0, ev1 in done:
            span = Span(name, start, end, tid, sid, parent, root, device)
            if ev0 is not None:
                host, anchor = self._anchor
                span.device_start = host + round(anchor.elapsed_time(ev0) * 1e6)
                span.device_end = host + round(anchor.elapsed_time(ev1) * 1e6)
            spans.append(span)
        return spans, counters


# the process's one tracer; the program's layers mark their phases on it
tracer = Tracer()
