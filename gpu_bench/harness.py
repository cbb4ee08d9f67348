"""The benchmark's harness: finds a cell's pieces by the names in
``BENCHMARK.json``, builds the system under test, drives the measured
window, judges what the window produced and prints the result.

Pieces, each found by name, so that a later cell, configuration, traffic
mix or metric is a new file and a new entry, never an edit:

* ``configs/<config>.json``: one configuration; its ``setup`` names
  ``setups/<setup>.py``, whose function named by the traffic's ``target``
  builds the system from the seed and returns a target object;
* ``traffic/<mix>.json``: one traffic mix's parameters; its ``driver``
  names ``drivers/<driver>.py``, the general loop that drives a target;
* ``metrics/<metric>.py``: one metric's reader, ``read(record)``, which
  returns a number or None (nothing to read: the metric is left out).

A target has ``shapes(window)``, ``free()`` and ``check(window)``, plus
what its driver calls (``step()`` or ``request(users)``, ``num_users()``).
``shapes`` gives the raw sizes of each step or request of a window (batch
and edge counts, users and exclusions, widths), which the metrics turn into
work themselves (``work.py``): a metric added later reads them without an
edit to the setup.

A run measures one window with tracing off; every end-to-end metric, and
every per-layer metric read from the host's clock, is taken from it. With
``--trace 1`` a second window of at most ``TRACE_SECONDS`` follows under the
profiler, for the metrics read from the device's timeline, so that the
profiler's cost stretches no host-clock metric.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "laplace_gnn_recommendation_tpu")
TRACE_SECONDS = 10.0


class BenchError(RuntimeError):
    """A run that cannot give a result (exits non-zero, prints none)."""


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    path = os.path.join(BENCH_DIR, kind, f"{name}.json")
    if not os.path.exists(path):
        raise BenchError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


_modules: Dict[str, object] = {}


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold '.' and '-')."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if path in _modules:
        return _modules[path]
    if not os.path.exists(path):
        raise BenchError(f"no {kind} module named {name!r} ({path})")
    mod_name = "gpu_bench._" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    _modules[path] = mod
    return mod


def find_cell(spec: dict, workload: str) -> dict:
    for wl in spec["workloads"]:
        if wl["name"] == workload:
            return wl
    raise BenchError(f"no workload named {workload!r} in BENCHMARK.json")


def cell_metrics(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             config_override: Optional[dict] = None, control: int = 0) -> dict:
    """One run of a cell; returns the result's fields (and ``checks``)."""
    import torch

    from .trace import DeviceTrace, Spans, breakdown, union_length

    t_start = time.perf_counter() if t_start is None else t_start
    wl = find_cell(spec, workload)
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise BenchError(f"{wl['chips']} cards asked for, {torch.cuda.device_count()} present")
    dev = torch.device(device)
    config = load_json("configs", wl["config"])
    if config_override:
        config = _merge(config, config_override)
    traffic = load_json("traffic", wl["traffic"])
    setup = load_module("setups", config["setup"])
    driver = load_module("drivers", traffic["driver"])
    spans = Spans()
    target = getattr(setup, traffic["target"])(config, traffic, seed, dev, spans, control=control)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    window = driver.run(target, traffic, seed, seconds, spans)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    lo, hi = window["t0_ns"], window["t1_ns"]
    record = {
        "workload": workload, "window": window, "window_s": (hi - lo) / 1e9, "setup_s": setup_s,
        "spans": spans.spans, "counters": spans.counters, "shapes": target.shapes(window),
        "config": config, "traffic": traffic, "events": [],
    }
    if trace and on_card:
        tspans = Spans()
        with DeviceTrace(torch) as dt:
            twin = driver.run(target, traffic, seed, min(seconds, TRACE_SECONDS), tspans)
        record.update(trace_window=twin, trace_spans=tspans.spans, events=dt.events,
                      trace_shapes=target.shapes(twin))
    target.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = target.check(window)
    windows = [window] + ([record["trace_window"]] if "trace_window" in record else [])
    failed = sum(int(w.get("failed", 0)) for w in windows)
    first_error = next((w["first_error"] for w in windows if w.get("first_error")), None)
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)

    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": bool(correct), "attempted": int(window["attempted"]), "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(wl["chips"]),
            "memory_peak_bytes": peak,
        },
    }
    if first_error:
        out["first_error"] = first_error
    if trace and on_card:
        tw, events = record["trace_window"], record["events"]
        tlo, thi = tw["t0_ns"], tw["t1_ns"]
        out["device"]["busy_s"] = union_length([(a, b) for _, a, b in events], tlo, thi) / 1e9
        out["device"]["window_s"] = (thi - tlo) / 1e9
        out["breakdown"] = breakdown(events, record["trace_spans"], tlo, thi)
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    found = forbidden_modules()
    if found:
        raise BenchError("modules of JAX or of the JAX package were loaded: " + ", ".join(found))
    return out


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1, 2), default=0,
                    help="put the reference in the program's place: 1 one precision below "
                         "the configuration's, 2 with half of each batch left out (train cells)")
    args = ap.parse_args(argv)
    try:
        spec = load_spec()
        out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=t_start, control=args.control)
    except BenchError as e:
        print(f"gpu_bench: {e}", file=sys.stderr)
        return 2
    from .work import PEAK_BYTES_PER_S, PEAK_FLOPS

    print(f"peaks: {json.dumps(PEAK_FLOPS)} FLOP/s, {PEAK_BYTES_PER_S:.3e} B/s; card: {card_line()}",
          file=sys.stderr)
    if out.get("first_error"):
        print(f"first failed request: {out['first_error']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0
