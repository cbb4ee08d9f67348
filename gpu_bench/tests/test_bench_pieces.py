"""The harness's pieces: lookup by name (a cell, and a metric of an existing
cell, added as new files only), seeded inputs, work counts, the idle-share
arithmetic, and no JAX."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from gpu_bench import harness, hm_graph, trace, work
from gpu_bench.drivers import requests_closed

TINY_BATCH = TINY["lightgcn-hm"]["batch_size"]


def test_every_named_piece_exists(spec):
    for wl in spec["workloads"]:
        cfg = harness.load_json("configs", wl["config"])
        mix = harness.load_json("traffic", wl["traffic"])
        setup = harness.load_module("setups", cfg["setup"])
        assert callable(getattr(setup, mix["target"]))
        harness.load_module("drivers", mix["driver"])
    bench = harness.load_spec()
    for wl in bench["workloads"]:
        for trace_on in (False, True):
            names = [m["name"] for m in harness.cell_metrics(bench, wl["name"], trace_on)]
            assert names, (wl["name"], trace_on)
            for n in names:
                assert callable(harness.load_module("metrics", n).read)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_a_cell_added_as_new_files_only(tmp_path):
    """A configuration, setup, traffic mix, metric and cell written as new
    files beside a copy of the benchmark run through the unchanged harness."""
    shutil.copytree(os.path.join(ROOT, "gpu_bench"), tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "gpu_bench"
    (b / "configs" / "dummy-cfg.json").write_text(json.dumps({"setup": "dummy", "per_step": 7}))
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps({"driver": "train_loop", "target": "train"}))
    (b / "setups" / "dummy.py").write_text(
        "class T:\n"
        "    def __init__(self, c): self.c = c\n"
        "    def sync(self): pass\n"
        "    def step(self, spans):\n"
        "        spans.add('dummy_steps')\n"
        "        return {'units': self.c['per_step']}\n"
        "    def shapes(self, w): return w['step_shapes']\n"
        "    def free(self): pass\n"
        "    def check(self, w): return [('always', 0.0, 0.0)]\n"
        "def train(config, traffic, seed, dev, spans, control=False): return T(config)\n")
    (b / "metrics" / "dummy.count.py").write_text(
        "def read(record): return record['counters']['dummy_steps']\n")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy-cfg", "traffic": "dummy-mix",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "dummy.count", "unit": "steps", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "from gpu_bench import harness;"
            "out = harness.run_cell(harness.load_spec(sys.argv[1]), 'dummy.cell', 5, 0.2, False, device='cpu');"
            "print(json.dumps(out))")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path), ROOT], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["dummy.count"]["value"] == out["attempted"] > 0
    assert "setup_s" in out["metrics"]


def _tiny_graph():
    return {"num_users": 500, "num_items": 300, "avg_degree": 6.0, "popularity_alpha": 0.8,
            "num_clusters": 10, "in_cluster_p": 0.85}


def test_graph_repeats_from_the_seed():
    def edges(seed):
        return hm_graph.generate(_tiny_graph(), torch.Generator().manual_seed(seed))

    a, b, c = edges(2**31 + 5), edges(2**31 + 5), edges(2**31 + 6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not (a[0].shape == c[0].shape and torch.equal(a[1], c[1]))
    key = a[0] * 300 + a[1]
    assert bool((key[1:] > key[:-1]).all())          # sorted and unique
    assert int(a[0].min()) == 0 and int(torch.bincount(a[0]).min()) >= 1


def test_request_stream_repeats_and_covers_every_user():
    mix = {"request_users": 30}

    def first(seed, n=12):
        s = requests_closed.request_stream(mix, seed, 100)
        return [next(s) for _ in range(n)]

    a, b, c = first(2**31 + 9), first(2**31 + 9), first(2**31 + 10)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [len(x) for x in a] == [len(x) for x in c] == [30, 30, 30, 10] * 3   # same sizes
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))                  # other order
    for p in range(3):   # each pass holds every user once, each in its own order
        assert sorted(np.concatenate(a[4 * p: 4 * p + 4]).tolist()) == list(range(100))
    assert not np.array_equal(np.concatenate(a[:4]), np.concatenate(a[4:8]))


def test_a_metric_added_to_an_existing_cell(tmp_path):
    """A per-layer metric written as a new file beside a copy of the
    benchmark, with an entry naming an existing cell, reads that cell's raw
    shapes and counts its work itself, through the unchanged harness and
    setup."""
    shutil.copytree(os.path.join(ROOT, "gpu_bench"), tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "gpu_bench" / "metrics" / "bpr_rows_share.py").write_text(
        "from gpu_bench import work\n"
        "def read(record):\n"
        "    s = record['shapes']\n"
        "    return sum(work.seconds(work.bpr_rows(x['batch'], x['width'])) for x in s) / len(s)\n")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["per_layer"].append({"name": "bpr_rows_share", "unit": "s", "better": "lower",
                              "source": "program_counter", "layer": "LightGCN train step",
                              "moves": "lgcn_train_samples_per_s",
                              "workloads": ["lightgcn-hm.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "sys.path.append(sys.argv[2] + '/gpu_bench/tests');"
            "from gpu_bench import harness; from conftest import TINY;"
            "out = harness.run_cell(harness.load_spec(sys.argv[1]), 'lightgcn-hm.train', 5, 0.3, True,"
            " device='cpu', config_override=TINY['lightgcn-hm']);"
            "print(json.dumps(out))")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path), ROOT], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    d = 32
    assert out["metrics"]["bpr_rows_share"]["value"] == pytest.approx(
        work.seconds(work.bpr_rows(TINY_BATCH, d)))
    assert "lgcn_train.mfu" in out["metrics"] and "lgcn_train.issue_ms" in out["metrics"]


def test_work_counts_by_hand():
    s = work.spmm(num_edges=10, num_dst=3, num_src=5, width=4, gather_dtype="bf16")
    assert s.flops == 2 * 10 * 4
    assert s.bytes == 10 * 8 + 4 * 4 + 5 * 4 * 2 + 3 * 4 * 4
    p = work.lightgcn_propagation(10, 3, 5, 4, hops=2, gather_dtype="f32")
    assert p.flops == 2 * 2 * (2 * 10 * 4)
    assert p.bytes == 2 * ((80 + 16 + 5 * 16 + 3 * 16) + (80 + 24 + 3 * 16 + 5 * 16))
    a = work.adam(100)
    assert (a.flops, a.bytes) == (1200, 2800)
    m = work.masked_mips(users=2, num_items=10, width=4, k=3, excluded=5)
    assert m.flops == 2 * 2 * 10 * 4 and m.bytes == 2 * 16 + 10 * 16 + 5 * 4 + 2 * 3 * 8
    lin = work.linear(rows=3, fan_in=4, fan_out=5)
    assert lin.flops == 2 * 3 * 4 * 5 and lin.bytes == 4 * (12 + 20 + 15)
    assert work.seconds(work.Work(67e12, 0.0, "f32")) == pytest.approx(1.0)
    assert work.seconds(work.Work(0.0, 3.35e12, "bf16")) == pytest.approx(1.0)
    assert work.bound(work.Work(1.0, 1e9)) == "bytes"


def test_idle_share_on_overlapping_streams():
    # two streams overlap on [20, 30); a copy inside a kernel adds nothing
    ev = [(0, 10), (20, 40), (25, 30), (30, 50), (70, 80), (90, 120)]
    assert trace.union_length(ev, 0, 100) == 10 + 30 + 10 + 10
    assert trace.idle_share(ev, 0, 100) == pytest.approx(40.0)
    assert trace.idle_gaps(ev, 0, 100) == [(10, 20), (50, 70), (80, 90)]
    spans = [("step", 0, 60), ("sync", 60, 100), ("inner", 45, 55)]
    assert trace.open_span(spans, 50) == "inner" and trace.open_span(spans, 75) == "sync"
    bd = trace.breakdown([("k1", 0, 10), ("k2", 20, 40), ("k1", 30, 50)], spans, 0, 100)
    assert bd["device_ops"][0] == ["k1", 30e-9]
    assert bd["idle_gaps"][0] == ["inner", 50e-9]   # the gap [50, 100) begins inside "inner"


def test_nothing_imports_jax():
    """Every module of the benchmark, and a whole tiny run of each cell, load
    no module whose top-level name is JAX's or the JAX package's."""
    code = """
import glob, json, os, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, os.path.join(sys.argv[1], "gpu_bench", "tests"))
from gpu_bench import harness
from conftest import run_tiny
spec = harness.load_spec()
for kind in ("setups", "drivers", "metrics"):
    for f in glob.glob(os.path.join(harness.BENCH_DIR, kind, "*.py")):
        harness.load_module(kind, os.path.basename(f)[:-3])
import gpu_bench.reference.lightgcn, gpu_bench.reference.sage, gpu_bench.trace, gpu_bench.work
for wl in spec["workloads"]:
    run_tiny(spec, wl["name"], seconds=0.2)
print(json.dumps(harness.forbidden_modules()))
"""
    r = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
