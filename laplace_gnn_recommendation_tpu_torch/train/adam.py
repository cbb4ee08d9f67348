"""Adam as optax computes it — the port's counterpart of the optimizers the
JAX pipelines train with:

* :class:`Adam` — plain ``optax.adam(lr)``, the ranking stack's
  (JAX ``train/encdec_pipeline.py:219``); state ``(ScaleByAdamState(count,
  mu, nu), EmptyState())``;
* :class:`StaircaseAdam` — LightGCN's ``optax.adam(optax.exponential_decay(
  lr, lr_decay_every, 0.95, staircase=True))`` (JAX
  ``train/lightgcn_pipeline.py:150-156``; the reference's
  ``ExponentialLR(0.95)`` every ``lr_decay_every`` steps); state
  ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``.

``train/optim.py`` of the JAX package is the lazy sparse Adam of PinSAGE, a
different optimizer. Params, gradients and moments are trees of tensors
(dataclasses, dicts, lists; ``train.checkpoint.tree_map_with_path``), so a
JAX state carries over leaf by leaf and a checkpoint has the JAX package's
keys. The count lives on the host, so the step's learning rate is known
without reading the card.

Update n (from 0) uses lr₀·0.95^⌊n/lr_decay_every⌋ — optax evaluates the
schedule at the count before its increment — and, with t = n + 1,

    mu ← b1·mu + (1-b1)·g,   nu ← b2·nu + (1-b2)·g²,
    p  ← p − lr/(1-b1^t) · mu / (sqrt(nu)/sqrt(1-b2^t) + eps),

optax's update (ε outside the square root of the bias-corrected second
moment) in the order ``torch.optim.Adam`` rounds it; plain Adam is the same
with lr fixed. The tables, ``mu`` and ``nu`` are updated in place (no copy
of a table per step), so a snapshot must be a copy
(``train.checkpoint.tree_clone``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from .checkpoint import tree_leaves_with_path, tree_map_with_path

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


@dataclass
class EmptyState:
    """optax's ``EmptyState`` (a constant learning rate's): no leaves."""


def _tensors(tree) -> List[torch.Tensor]:
    return [x for _, x in tree_leaves_with_path(tree)]


def staircase_lr(learning_rate: float, decay_every: int, count: int) -> float:
    """lr₀·0.95^⌊count/decay_every⌋ (``optax.exponential_decay``, staircase)."""
    return learning_rate * DECAY_RATE ** (count // decay_every)


class Adam:
    """``optax.adam(learning_rate)`` over params given as a tree of tensors."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def _lr(self, count: int) -> float:
        return self.learning_rate

    def _tail(self, count: int):
        return EmptyState()

    def init(self, params) -> Tuple[ScaleByAdamState, Any]:
        zeros = lambda: tree_map_with_path(lambda _, x: torch.zeros_like(x), params)
        return ScaleByAdamState(count=0, mu=zeros(), nu=zeros()), self._tail(0)

    def update_(self, grads, state, params) -> Tuple[ScaleByAdamState, Any]:
        """Apply one update to ``params`` in place from ``grads`` (a tree
        like the params); returns the state with its counts advanced."""
        adam = state[0]
        lr = self._lr(adam.count)
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
        return ScaleByAdamState(count=t, mu=adam.mu, nu=adam.nu), self._tail(t)


class StaircaseAdam(Adam):
    """Adam with the staircase schedule (LightGCN's)."""

    def __init__(self, learning_rate: float, decay_every: int):
        super().__init__(learning_rate)
        self.decay_every = decay_every

    def _lr(self, count: int) -> float:
        return staircase_lr(self.learning_rate, self.decay_every, count)

    def _tail(self, count: int):
        return ScaleByScheduleState(count=count)
