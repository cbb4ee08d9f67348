"""Hyperparameter optimization — the port of the JAX package's
``train/hpo.py``: reference ``run_hpo.py`` (optuna, 40 trials, minimize
1 − precision_val) and the wandb random sweep (``sweep.yaml`` +
``run_sweep.py``). Without optuna the engine is a built-in seeded random
search over the same space with the same objective (one seed draws the JAX
package's trials); optuna is used when it is importable. Successive halving
resumes each trial from its own directory, so a LightGCN trial's later
rungs continue through kernel A where its first stopped.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from ..configs import Config, link_pred_config

# The search space of reference run_hpo.py:14-50 / sweep.yaml:11-37.
SEARCH_SPACE: Dict[str, list] = {
    "num_gnn_layers": [1, 2, 3, 4],
    "num_linear_layers": [1, 2, 3, 4],
    "hidden_layer_size": [32, 64, 128, 256, 512],
    "encoder_layer_output_size": [32, 64, 128, 256, 512],
    "conv_agg_type": ["add", "mean", "max"],
    "heterogeneous_prop_agg_type": ["sum", "mean", "min", "max", "mul"],
    "learning_rate": [1e-2, 1e-3, 1e-4, 1e-5, 1e-6],
    "num_neighbors": [24, 32, 64, 128],
    "candidate_pool_size": [24, 64, 128, 256],
    "positive_edges_ratio": [0.2, 0.5, 0.8, 1.0],
    "negative_edges_ratio": [1.0, 2.0, 5.0, 10.0, 20.0],
    "p_dropout_features": [0.0, 0.15, 0.3, 0.5],
}


def load_sweep_yaml(path: str = "sweep.yaml") -> Dict[str, list]:
    """Load a wandb-sweep-format config artifact into a SEARCH_SPACE dict
    (the reference drives its sweep from ``sweep.yaml:11-37``);
    ``resolve_search_space`` prefers the artifact when present, so editing
    sweep.yaml changes what ``run_study``/``run_hpo`` explore.

    ``values`` lists pass through; ``{min, max, int_uniform}`` ranges expand
    to the integer grid. Uses a minimal parser (the image has no yaml
    package) that covers the sweep schema subset.
    """
    space: Dict[str, list] = {}
    cur: Optional[str] = None
    rng_lo = rng_hi = None
    in_params = False

    def flush():
        nonlocal rng_lo, rng_hi
        if cur is not None and rng_lo is not None and rng_hi is not None:
            space[cur] = list(range(int(rng_lo), int(rng_hi) + 1))
        rng_lo = rng_hi = None

    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            indent = len(line) - len(line.lstrip())
            body = line.strip()
            if body.startswith("parameters:") and indent == 0:
                in_params = True
                continue
            if not in_params:
                continue
            if indent == 0:
                break
            if indent == 2 and body.endswith(":"):
                flush()
                cur = body[:-1]
            elif body.startswith("values:"):
                vals = body.split(":", 1)[1].strip().strip("[]")
                space[cur] = [_parse_sweep_value(v) for v in vals.split(",")]
            elif body.startswith("min:"):
                rng_lo = float(body.split(":", 1)[1])
            elif body.startswith("max:"):
                rng_hi = float(body.split(":", 1)[1])
    flush()
    return space


def _parse_sweep_value(v: str):
    v = v.strip().strip("'").strip('"')
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v  # categorical strings pass through


def resolve_search_space(path: str = "sweep.yaml") -> Dict[str, list]:
    """The sweep.yaml artifact when present (reference behavior: the YAML
    drives the sweep), else the built-in ``SEARCH_SPACE``."""
    if os.path.exists(path):
        loaded = load_sweep_yaml(path)
        if loaded:
            return loaded
    return SEARCH_SPACE


def sample_trial(
    rng: np.random.Generator, space: Optional[Dict[str, list]] = None
) -> Dict:
    space = space if space is not None else SEARCH_SPACE
    params = {k: rng.choice(v).item() if isinstance(v[0], (int, float)) else v[rng.integers(len(v))]
              for k, v in space.items()}
    # n_hop_neighbors tied to num_gnn_layers as in run_hpo.py:38
    if "num_gnn_layers" in params:
        params["n_hop_neighbors"] = params["num_gnn_layers"]
    return params


def make_trial_config(base, params: Dict):
    """Works for BOTH config dataclasses (the study objective decides which
    pipeline runs — ``run_hpo`` uses the encdec ``Config``, ``hpo_hm.py``
    the ``LightGCNConfig``)."""
    cfg = dataclasses.replace(base)
    for k, v in params.items():
        setattr(cfg, k, v)
    # keep k ≤ 2·candidate_pool_size invariant (run_pipeline.py:32-34)
    if hasattr(cfg, "candidate_pool_size"):
        cfg.candidate_pool_size = max(cfg.candidate_pool_size, cfg.k)
    return cfg


def run_study(
    objective: Callable[[Config], float],
    base: Config,
    n_trials: int = 40,
    seed: int = 0,
    out_csv: Optional[str] = "output/trials.csv",
    search_space: Optional[Dict[str, list]] = None,
) -> Dict:
    """Minimize ``objective(config)`` (reference objective: 1 − precision_val,
    ``run_hpo.py:52``). Returns the best params dict; writes a trials table.
    """
    space = search_space if search_space is not None else resolve_search_space()
    try:  # pragma: no cover - optuna not in the image
        import optuna

        def train(trial):
            params = {
                k: trial.suggest_categorical(k, v) for k, v in space.items()
            }
            if "num_gnn_layers" in params:
                params["n_hop_neighbors"] = params["num_gnn_layers"]
            return objective(make_trial_config(base, params))

        study = optuna.create_study()
        study.optimize(train, n_trials=n_trials)
        best = study.best_params
        if out_csv:
            os.makedirs(os.path.dirname(out_csv), exist_ok=True)
            study.trials_dataframe().to_csv(out_csv)
        return best
    except ImportError:
        pass

    rng = np.random.default_rng(seed)
    rows: List[Dict] = []
    best_val, best_params = float("inf"), {}
    for i in range(n_trials):
        params = sample_trial(rng, space)
        val = objective(make_trial_config(base, params))
        rows.append({"trial": i, "value": val, **params})
        if val < best_val:
            best_val, best_params = val, params
        print(f"| trial {i}: value={val:.5f} best={best_val:.5f}")
    if out_csv:
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        with open(out_csv, "w") as f:
            keys = list(rows[0].keys())
            f.write(",".join(keys) + "\n")
            for r in rows:
                f.write(",".join(str(r[k]) for k in keys) + "\n")
    return best_params


def run_successive_halving(
    objective: Callable[[Config, int, str], float],
    base: Config,
    param_sets: Optional[List[Dict]] = None,
    n_trials: int = 8,
    rungs=(300, 1000),
    eta: int = 2,
    work_dir: str = "output/sh",
    seed: int = 0,
    search_space: Optional[Dict[str, list]] = None,
    log_fn=print,
) -> Dict:
    """Multi-stage HPO with early termination — the reference's hyperband
    counterpart (``sweep.yaml:24-27`` early_terminate: hyperband; optuna's
    pruning semantics in ``run_hpo.py:55-58``).

    ``objective(cfg, budget, trial_dir)`` must train the trial to TOTAL
    ``budget`` steps — resuming its own prior state from ``trial_dir`` when
    present (wire ``cfg.artifact_dir=trial_dir, cfg.resume=True,
    cfg.checkpoint_every=budget-1`` into ``lightgcn_pipeline.train`` and a
    rung-2 call continues rung-1's optimizer state instead of restarting) —
    and return the value to MINIMIZE.

    Each rung evaluates the surviving trials at ``rungs[r]`` cumulative
    steps and keeps the top ``1/eta`` fraction. ``param_sets`` gives
    explicit stage-designed candidates; otherwise ``n_trials`` are sampled
    from the search space. Returns ``{"best": .., "best_value": ..,
    "history": [...]}`` with one history row per (rung, trial).
    """
    if param_sets is None:
        rng = np.random.default_rng(seed)
        space = search_space if search_space is not None else resolve_search_space()
        param_sets = [sample_trial(rng, space) for _ in range(n_trials)]
    survivors = list(enumerate(param_sets))
    history: List[Dict] = []
    best_params: Dict = {}
    best_val = float("inf")
    for r, budget in enumerate(rungs):
        results = []
        for tid, params in survivors:
            cfg = make_trial_config(base, params)
            tdir = os.path.join(work_dir, f"trial_{tid}")
            os.makedirs(tdir, exist_ok=True)
            val = float(objective(cfg, int(budget), tdir))
            results.append((val, tid, params))
            history.append(
                {"rung": r, "budget": int(budget), "trial": tid, "value": val,
                 **params}
            )
            log_fn(f"| rung {r} (budget {budget}) trial {tid}: value={val:.5f}")
        results.sort(key=lambda t: t[0])
        if results and results[0][0] < best_val:
            best_val, best_params = results[0][0], results[0][2]
        keep = max(1, len(results) // eta)
        survivors = [(tid, p) for _, tid, p in results[:keep]]
        log_fn(
            f"| rung {r} done: keeping {keep}/{len(results)} -> trials "
            f"{[tid for tid, _ in survivors]}"
        )
    return {"best": best_params, "best_value": best_val, "history": history}


def run_hpo(artifact_dir: str, n_trials: int = 40, device="cuda") -> Dict:
    """End-to-end HPO over the encoder-decoder pipeline on ``device`` —
    reference ``run_hpo.py`` settings (epochs=4, eval_every=4,
    break_at=50)."""
    from ..data.link_pred_data import create_link_pred_data_from_artifacts
    from .encdec_pipeline import run_pipeline

    base = dataclasses.replace(
        link_pred_config, epochs=4, k=12, eval_every=4, evaluate_break_at=50
    )

    def objective(cfg: Config) -> float:
        data, _ = create_link_pred_data_from_artifacts(artifact_dir, cfg, device=device)
        stats = run_pipeline(cfg, data, log_fn=lambda *_: None, device=device)
        return 1.0 - stats.precision_val

    best = run_study(objective, base, n_trials=n_trials)
    print("best params:", json.dumps(best, default=str))
    return best
