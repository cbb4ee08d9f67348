"""Adam under a staircase learning-rate decay — the port's counterpart of
the optimizer the JAX LightGCN pipeline trains with,
``optax.adam(optax.exponential_decay(lr, lr_decay_every, 0.95,
staircase=True))`` (JAX ``train/lightgcn_pipeline.py:150-156``; the
reference's ``ExponentialLR(0.95)`` every ``lr_decay_every`` steps,
``run_pipeline_lightgcn.py:104,178-179``). ``train/optim.py`` of the JAX
package is the lazy sparse Adam of PinSAGE, a different optimizer.

The state mirrors optax's tree: ``(ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count))``, so a JAX state carries over leaf by leaf
(``models.lightgcn.lightgcn_adam_state_from_jax``) and a checkpoint has
the JAX package's keys. The count lives on the host, so the step's
learning rate is known without reading the card.

Update n (from 0) uses lr₀·0.95^⌊n/lr_decay_every⌋ — optax evaluates the
schedule at the count before its increment — and, with t = n + 1,

    mu ← b1·mu + (1-b1)·g,   nu ← b2·nu + (1-b2)·g²,
    p  ← p − lr/(1-b1^t) · mu / (sqrt(nu)/sqrt(1-b2^t) + eps),

optax's update (ε outside the square root of the bias-corrected second
moment) in the order ``torch.optim.Adam`` rounds it. The tables, ``mu`` and
``nu`` are updated in place (no copy of a table per step), so a snapshot
must be a copy (``train.checkpoint.tree_clone``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

DECAY_RATE = 0.95
B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults, the ones the JAX pipeline uses


@dataclass
class ScaleByAdamState:
    """optax's ``ScaleByAdamState``: update count and both moments, each a
    tree shaped like the params (a dataclass of tensors)."""

    count: int
    mu: Any
    nu: Any


@dataclass
class ScaleByScheduleState:
    """optax's ``ScaleByScheduleState``: the count the schedule reads."""

    count: int


def _tensors(tree) -> List[torch.Tensor]:
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def staircase_lr(learning_rate: float, decay_every: int, count: int) -> float:
    """lr₀·0.95^⌊count/decay_every⌋ (``optax.exponential_decay``, staircase)."""
    return learning_rate * DECAY_RATE ** (count // decay_every)


class StaircaseAdam:
    """Adam with the staircase schedule, over params given as a dataclass of
    tensors (``LightGCNParams``)."""

    def __init__(self, learning_rate: float, decay_every: int):
        self.learning_rate, self.decay_every = learning_rate, decay_every

    def init(self, params) -> Tuple[ScaleByAdamState, ScaleByScheduleState]:
        zeros = lambda: dataclasses.replace(
            params, **{f.name: torch.zeros_like(getattr(params, f.name))
                       for f in dataclasses.fields(params)})
        return ScaleByAdamState(count=0, mu=zeros(), nu=zeros()), ScaleByScheduleState(count=0)

    def update_(self, grads, state, params) -> Tuple[ScaleByAdamState, ScaleByScheduleState]:
        """Apply one update to ``params`` in place from ``grads`` (a tree
        like the params); returns the state with its counts advanced."""
        adam, _ = state
        lr = staircase_lr(self.learning_rate, self.decay_every, adam.count)
        t = adam.count + 1
        g, mu, nu, p = _tensors(grads), _tensors(adam.mu), _tensors(adam.nu), _tensors(params)
        with torch.no_grad():
            torch._foreach_lerp_(mu, g, 1.0 - B1)
            torch._foreach_mul_(nu, B2)
            torch._foreach_addcmul_(nu, g, g, 1.0 - B2)
            denom = torch._foreach_sqrt(nu)
            torch._foreach_div_(denom, math.sqrt(1.0 - B2 ** t))
            torch._foreach_add_(denom, EPS)
            torch._foreach_addcdiv_(p, mu, denom, -lr / (1.0 - B1 ** t))
        return (ScaleByAdamState(count=t, mu=adam.mu, nu=adam.nu),
                ScaleByScheduleState(count=t))
