"""Run statistics + optional experiment tracking (a copy of the JAX
package's ``train/reporting.py``, which imports no JAX).

Mirrors the reference's ``reporting/types.py:5-35`` stat dataclasses and the
wandb plumbing of ``reporting/wandb.py:13-85``; wandb is optional — when it
is not installed every call degrades to stdout logging.

``Stats.loss_curve``: the port's LightGCN ``train`` fills it with every
step's train loss (the JAX pipeline leaves it ``None``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Stats:
    """Final run stats (reference ``reporting/types.py``).

    ``truncations`` surfaces the sampler's padded-batch overflow counters
    (edges/labels/nodes dropped when a subgraph exceeds its static budget —
    the silent-truncation correctness trap of SURVEY §7). Zero for every
    healthy run; the acceptance tier asserts it.
    """

    loss: float
    recall_val: float
    recall_test: float
    precision_val: float
    precision_test: float
    truncations: Dict[str, int] = field(default_factory=dict)
    params: Optional[Any] = field(default=None, repr=False, compare=False)
    # per-epoch mean train losses — lets callers assert on a robust
    # statistic (e.g. mean of the last k epochs) instead of the single
    # final-epoch value, which at tiny scales oscillates within a
    # run-to-run variance band (SURVEY §7)
    loss_curve: Optional[list] = field(default=None, repr=False, compare=False)
    """The run's final (post-model-selection) parameters, populated only
    when the pipeline's config sets ``return_params`` — benches and callers
    that score or serve the trained model read them from here instead of
    re-loading exported artifacts. Device tensors; never serialized."""


@dataclass
class ContinousStatsTrain:
    type: str
    loss: float
    epoch: int


@dataclass
class ContinousStatsVal:
    type: str
    recall_val: float
    precision_val: float
    epoch: int


@dataclass
class ContinousStatsTest:
    type: str
    recall_test: float
    precision_test: float


def _try_wandb():
    try:  # pragma: no cover - wandb not installed in CI image
        import wandb  # type: ignore

        return wandb
    except Exception:
        return None


def setup_config(project: str, enabled: bool, config) -> tuple:
    """Login+init if wandb is available and enabled; returns (wandb|None, config).

    Reference ``reporting/wandb.py:27-51`` also overrides config fields from
    ``wandb.config`` during sweeps; we apply the same override when the run
    was launched by a sweep agent.
    """
    if not enabled:
        return None, config
    wandb = _try_wandb()
    if wandb is None:
        print("| wandb not available; continuing with stdout reporting")
        return None, config
    run = wandb.init(project=project, config=dataclasses.asdict(config))
    for key, value in dict(run.config).items():
        if hasattr(config, key):
            setattr(config, key, value)
    return wandb, config


def report_results(output_stats: Any, wandb: Optional[Any], final: bool) -> None:
    """Log one stat record (reference ``reporting/wandb.py:54-85``)."""
    payload = dataclasses.asdict(output_stats)
    if wandb is None:
        kind = payload.pop("type", "final")
        line = ", ".join(f"{k}={v}" for k, v in payload.items())
        print(f"| [{kind}] {line}")
        return
    wandb.log(payload)  # pragma: no cover
    if final:
        wandb.finish()  # pragma: no cover
