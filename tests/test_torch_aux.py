"""The auxiliary subsystems of the PyTorch port against the JAX package's:
``utils/tensor.py`` on seeded inputs (exact), ``train/hpo.py`` (the same
trials for a seed, the same trials CSV byte for byte, the same successive-
halving history, and the resume wiring through the port's LightGCN
``train``), ``utils/profiling.py`` (``Roofline``'s numbers equal the JAX
class's at the same peaks; ``Timer``; ``Profiler``; a ``torch.profiler``
Chrome trace) and ``utils/visualize.py`` (a PNG of a port batch). The ports
of ``tests/test_aux.py``'s cases."""
import dataclasses as dc
import json
import os

import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu.configs import Config as JConfig
from laplace_gnn_recommendation_tpu.train import hpo as jhpo
from laplace_gnn_recommendation_tpu.utils import profiling as jprof
from laplace_gnn_recommendation_tpu.utils import tensor as jtensor
from laplace_gnn_recommendation_tpu_torch.configs import (
    Config,
    LightGCNConfig,
    link_pred_config,
)
from laplace_gnn_recommendation_tpu_torch.train import hpo
from laplace_gnn_recommendation_tpu_torch.utils import profiling, tensor

quiet = lambda *_: None  # noqa: E731


# ---- utils/tensor.py ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tensor_utils_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 20, 15), rng.integers(0, 20, 9)
    for fn in ("intersection_1d", "difference_1d"):
        got, want = getattr(tensor, fn)(a, b), getattr(jtensor, fn)(a, b)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    ua = np.unique(a)
    np.testing.assert_array_equal(tensor.difference_1d(ua, np.unique(b), assume_unique=True),
                                  jtensor.difference_1d(ua, np.unique(b), assume_unique=True))
    rows = [rng.integers(0, 9, rng.integers(1, 6)) for _ in range(4)]
    for side, value in (("right", 0), ("left", -7)):
        np.testing.assert_array_equal(tensor.padded_stack(rows, side, value),
                                      jtensor.padded_stack(rows, side, value))
    mats = [rng.normal(size=(2, n)) for n in (3, 1, 4)]
    np.testing.assert_array_equal(tensor.padded_stack(mats, value=0.5),
                                  jtensor.padded_stack(mats, value=0.5))
    nested = [list(r) for r in rows]
    assert tensor.flatten(nested) == jtensor.flatten(nested)


def test_tensor_utils_cases():
    np.testing.assert_array_equal(tensor.intersection_1d(np.array([1, 2, 3]), np.array([2, 3, 4])),
                                  [2, 3])
    np.testing.assert_array_equal(tensor.difference_1d(np.array([5, 1, 9, 3]), np.array([1, 3])),
                                  [5, 9])
    np.testing.assert_array_equal(tensor.padded_stack([np.array([1, 2]), np.array([3])],
                                                      value=-7), [[1, 2], [3, -7]])
    assert tensor.flatten([[1, 2], [3]]) == [1, 2, 3]


# ---- train/hpo.py -------------------------------------------------------------

def test_search_space_equals_jax():
    assert hpo.SEARCH_SPACE == jhpo.SEARCH_SPACE


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_trial_equals_jax(seed):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        p = hpo.sample_trial(rng)
        assert p == jhpo.sample_trial(jrng)
        for k, v in p.items():
            assert v == p["num_gnn_layers"] if k == "n_hop_neighbors" else v in hpo.SEARCH_SPACE[k]


def test_trial_configs_valid():
    cfg = hpo.make_trial_config(link_pred_config, hpo.sample_trial(np.random.default_rng(1)))
    cfg.check_validity()
    lcfg = hpo.make_trial_config(LightGCNConfig(), {"learning_rate": 1e-2, "Lambda": 3e-6})
    assert lcfg.learning_rate == 1e-2 and lcfg.Lambda == 3e-6
    small = hpo.make_trial_config(link_pred_config, {"candidate_pool_size": 1, "k": 12})
    assert small.candidate_pool_size == 12


def test_run_study_equals_jax(tmp_path):
    """The built-in search (no optuna) draws the JAX package's trials for a
    seed and writes the same trials table byte for byte."""
    seen, jseen = [], []

    def objective(store):
        return lambda cfg: store.append(cfg) or abs(cfg.learning_rate - 1e-4) + cfg.num_gnn_layers

    best = hpo.run_study(objective(seen), link_pred_config, n_trials=25, seed=0,
                         out_csv=str(tmp_path / "port" / "trials.csv"))
    from laplace_gnn_recommendation_tpu.configs import link_pred_config as jlink

    jbest = jhpo.run_study(objective(jseen), jlink, n_trials=25, seed=0,
                           out_csv=str(tmp_path / "jax" / "trials.csv"))
    assert best == jbest and len(seen) == 25
    assert best["learning_rate"] == pytest.approx(1e-4) and best["num_gnn_layers"] == 1
    keys = list(hpo.resolve_search_space()) + ["n_hop_neighbors"]
    assert [{k: getattr(c, k) for k in keys} for c in seen] == \
        [{k: getattr(c, k) for k in keys} for c in jseen]
    assert (tmp_path / "port" / "trials.csv").read_bytes() == \
        (tmp_path / "jax" / "trials.csv").read_bytes()
    assert len((tmp_path / "port" / "trials.csv").read_text().strip().split("\n")) == 26


def test_successive_halving_equals_jax(tmp_path):
    """Halving per rung with cumulative budgets, each trial resuming its own
    directory: the same history as the JAX engine, on explicit and on
    sampled candidates."""
    def objective(store):
        def run(cfg, budget, trial_dir):
            state_f = os.path.join(trial_dir, "state.txt")
            prev = int(open(state_f).read()) if os.path.exists(state_f) else 0
            assert budget > prev
            open(state_f, "w").write(str(budget))
            store.append((cfg.learning_rate, budget, prev))
            return abs(cfg.learning_rate - 1e-3) + 1.0 / budget
        return run

    params = [{"learning_rate": lr} for lr in (1e-2, 1e-3, 1e-4, 1e-5)]
    seen, jseen = [], []
    out = hpo.run_successive_halving(objective(seen), Config(), param_sets=params,
                                     rungs=(10, 40), eta=2, work_dir=str(tmp_path / "p"),
                                     log_fn=quiet)
    jout = jhpo.run_successive_halving(objective(jseen), JConfig(), param_sets=params,
                                       rungs=(10, 40), eta=2, work_dir=str(tmp_path / "j"),
                                       log_fn=quiet)
    assert seen == jseen and [b for _, b, _ in seen] == [10, 10, 10, 10, 40, 40]
    assert all(p == 10 for _, b, p in seen if b == 40)
    assert out == jout and out["best"]["learning_rate"] == pytest.approx(1e-3)
    sampled = hpo.run_successive_halving(lambda c, b, d: c.learning_rate, Config(), n_trials=6,
                                         rungs=(1, 2, 3), eta=2, seed=4,
                                         work_dir=str(tmp_path / "s"), log_fn=quiet)
    jsampled = jhpo.run_successive_halving(lambda c, b, d: c.learning_rate, JConfig(),
                                           n_trials=6, rungs=(1, 2, 3), eta=2, seed=4,
                                           work_dir=str(tmp_path / "js"), log_fn=quiet)
    assert sampled == jsampled and len(sampled["history"]) == 6 + 3 + 1


def test_successive_halving_lightgcn_resume_wiring(tmp_path):
    """The successive-halving objective wired into the port's LightGCN
    ``train``: rung 2 continues rung 1's state from the trial directory
    (checkpoint at iteration 3 → resumes at 4), on the CPU."""
    from laplace_gnn_recommendation_tpu_torch.data.lightgcn_data import create_lightgcn_data
    from laplace_gnn_recommendation_tpu_torch.data.synthetic import random_bipartite_edges
    from laplace_gnn_recommendation_tpu_torch.train import lightgcn_pipeline

    eu, ei = random_bipartite_edges(seed=3, num_users=60, num_items=40, avg_degree=6)
    data = create_lightgcn_data(eu, ei, 60, 40, device="cpu")
    base = LightGCNConfig(hidden_layer_size=8, num_iterations=1, batch_size=32,
                          eval_every=1000, num_recommendations=4)
    resumed = []

    def objective(cfg, budget, trial_dir):
        cfg = dc.replace(cfg, epochs=budget, artifact_dir=trial_dir, resume=True,
                         checkpoint_every=max(1, budget - 1))
        msgs = []
        stats = lightgcn_pipeline.train(cfg, data, export=False, log_fn=msgs.append,
                                        device="cpu")
        resumed.extend(m for m in msgs if "Resuming" in m)
        return stats.loss

    out = hpo.run_successive_halving(objective, base,
                                     param_sets=[{"learning_rate": 1e-2},
                                                 {"learning_rate": 1e-3}],
                                     rungs=(4, 8), eta=2, work_dir=str(tmp_path / "sh"),
                                     log_fn=quiet)
    assert any("iteration 4" in m for m in resumed), resumed
    assert np.isfinite(out["best_value"]) and len(out["history"]) == 3


def test_run_hpo_objective_on_artifacts(tmp_path, monkeypatch):
    """``run_hpo`` trains the ranking stack from an artifact directory on the
    given device and minimises 1 − precision_val (one small trial here)."""
    from laplace_gnn_recommendation_tpu_torch.configs import preprocessing_config
    from laplace_gnn_recommendation_tpu_torch.data import preprocess_movielens

    raw = _movielens_raw(tmp_path)
    art = str(tmp_path / "derived")
    preprocess_movielens.preprocess(preprocessing_config, raw, art)
    values = []

    def one_trial(objective, base, n_trials=40, **_):
        cfg = hpo.make_trial_config(base, SMALL_TRIAL)
        assert (cfg.epochs, cfg.eval_every, cfg.evaluate_break_at) == (4, 4, 50)
        values.append(objective(cfg))
        return SMALL_TRIAL

    monkeypatch.setattr(hpo, "run_study", one_trial)
    assert hpo.run_hpo(art, device="cpu") == SMALL_TRIAL
    assert len(values) == 1 and 0.0 <= values[0] <= 1.0


SMALL_TRIAL = dict(num_gnn_layers=1, n_hop_neighbors=1, num_linear_layers=1,
                   hidden_layer_size=8, encoder_layer_output_size=8, num_neighbors=8,
                   candidate_pool_size=12, batch_size=4)


def _movielens_raw(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    (raw / "users.dat").write_text("".join(f"{i}::M::25::15::55117\n" for i in range(1, 16)))
    (raw / "movies.dat").write_text(
        "".join(f"{i}::Movie {i} (199{i % 10})::Comedy|Drama\n" for i in range(1, 13)))
    rows, ts = [], 956700000
    for u in range(1, 16):
        for m in rng.choice(np.arange(1, 13), size=5, replace=False):
            ts += 100
            rows.append(f"{u}::{m}::4::{ts}\n")
    (raw / "ratings.dat").write_text("".join(rows))
    return str(raw)


# ---- utils/profiling.py -------------------------------------------------------

@pytest.mark.parametrize("flops,bytes_moved", [(1e9, 500e6), (300e9, 1e6), (0.0, 0.0),
                                               (4e12, 2e10)])
def test_roofline_equals_jax(flops, bytes_moved):
    kw = dict(name="k", seconds=1e-3, flops=flops, bytes_moved=bytes_moved,
              peak_flops=profiling.H100_PEAK_FLOPS_BF16, peak_bytes=profiling.H100_PEAK_HBM_BYTES)
    r, j = profiling.Roofline(**kw), jprof.Roofline(**kw)
    for attr in ("achieved_flops", "achieved_bandwidth", "arithmetic_intensity", "bound",
                 "fraction_of_peak"):
        assert getattr(r, attr) == getattr(j, attr), attr
    assert r.report() == j.report()


def test_roofline_h100_defaults():
    mem = profiling.Roofline(name="spmm", seconds=1e-3, flops=1e9, bytes_moved=500e6)
    assert mem.bound == "memory" and 0 < mem.fraction_of_peak <= 1.0
    assert mem.fraction_of_peak == pytest.approx(500e9 / 3.35e12)
    assert "spmm" in mem.report()
    assert mem.peak_flops == 67e12   # f32 work unless told otherwise
    mm = profiling.Roofline(name="mm", seconds=1e-3, flops=300e9, bytes_moved=1e6,
                            dtype=torch.bfloat16)
    assert mm.bound == "compute" and mm.fraction_of_peak == pytest.approx(300e12 / 989e12)


@pytest.mark.parametrize("dtype,peak", [(torch.float32, 67e12), ("tf32", 495e12),
                                        (torch.bfloat16, 989e12), (torch.int8, 1979e12)])
def test_roofline_peak_from_dtype(dtype, peak):
    r = profiling.Roofline(name="mm", seconds=1e-3, flops=30e9, bytes_moved=1e6, dtype=dtype)
    assert r.peak_flops == peak
    assert r.bound == "compute" and r.fraction_of_peak == pytest.approx(30e12 / peak)
    with pytest.raises(ValueError, match="no H100 peak"):
        profiling.Roofline(name="mm", seconds=1e-3, dtype=torch.float64)


def test_profiler_and_timer(tmp_path):
    p = profiling.Profiler(every=1, dump_path=str(tmp_path / "s.dmp"))
    p.start()
    sum(range(1000))
    p.stop()
    assert p.count == 1 and os.path.getsize(tmp_path / "s.dmp") > 0
    with profiling.Timer() as t:
        sum(range(10000))
    assert t.elapsed > 0


def test_device_trace_writes_chrome_trace(tmp_path):
    import torch

    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())


# ---- utils/visualize.py -------------------------------------------------------

def test_visualize_batch_renders_png(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("networkx")
    from laplace_gnn_recommendation_tpu_torch.constants import EDGE_KEY
    from laplace_gnn_recommendation_tpu_torch.data.graph import HostCSR
    from laplace_gnn_recommendation_tpu_torch.data.sampler import SubgraphSampler
    from laplace_gnn_recommendation_tpu_torch.data.synthetic import manual_dummy_graph
    from laplace_gnn_recommendation_tpu_torch.utils.visualize import visualize_batch

    g = manual_dummy_graph()
    eu, ei = g.edges[EDGE_KEY]
    s = SubgraphSampler(Config(batch_size=2, num_neighbors=8, n_hop_neighbors=2, k=4),
                        HostCSR.from_edges(eu, ei, 3, 6), HostCSR.from_edges(ei, eu, 6, 3),
                        train=True, randomization=False)
    batch = s.sample_batch(np.array([0, 1]))
    for b, name in ((batch, "host.png"), (batch.to("cpu"), "tensors.png")):
        fig = visualize_batch(b, str(tmp_path / name))
        assert (tmp_path / name).stat().st_size > 1000
        import matplotlib.pyplot as plt

        plt.close(fig)


def test_cli_hpo(tmp_path, monkeypatch):
    """``--type hpo`` dispatches to ``run_hpo`` (no longer refused), which
    trains on the device the CLI was given."""
    import sys

    from laplace_gnn_recommendation_tpu_torch import cli
    from laplace_gnn_recommendation_tpu_torch.configs import preprocessing_config
    from laplace_gnn_recommendation_tpu_torch.data import preprocess_movielens

    art = str(tmp_path / "derived")
    preprocess_movielens.preprocess(preprocessing_config, _movielens_raw(tmp_path), art)
    values = []

    def one_trial(objective, base, n_trials=40, **_):
        assert n_trials == 40
        values.append(objective(hpo.make_trial_config(base, SMALL_TRIAL)))
        return SMALL_TRIAL

    monkeypatch.setattr(hpo, "run_study", one_trial)
    monkeypatch.setattr(sys, "argv", ["cli", "--type", "hpo", "--artifact_dir", art,
                                      "--device", "cpu"])
    cli.run()
    assert len(values) == 1 and 0.0 <= values[0] <= 1.0
