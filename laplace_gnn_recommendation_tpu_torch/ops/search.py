"""Vectorized binary search over CSR rows — the port of the JAX package's
``ops/search.py:21-60``.

The search is the JAX package's fixed-iteration lower bound within each
row's CSR slice, kept as it is (the JAX comment on why: a combined
``u·num_items + i`` key overflows int32 at H&M size), so every lane returns
the JAX package's index, also where ``max_range`` is smaller than a row.
All lanes step in lockstep for ``ceil(log2(max_range + 1))`` iterations,
each one gather; there is no data-dependent control flow and no host sync.
"""
from __future__ import annotations

import math

import torch


def lower_bound(
    sorted_vals: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    targets: torch.Tensor,
    max_range: int,
) -> torch.Tensor:
    """Per-lane ``lower_bound`` of ``targets`` in ``sorted_vals[lo:hi)``
    (parallel int tensors; int64 result). ``max_range`` bounds ``hi - lo``."""
    n = int(sorted_vals.shape[0])
    iters = max(1, math.ceil(math.log2(max_range + 1)))
    lo, hi = lo.long(), hi.long()
    for _ in range(iters):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = sorted_vals[torch.clamp(mid, max=n - 1)]
        active = lo < hi
        go_right = (v < targets) & active
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(~go_right & active, mid, hi))
    return lo


def batched_membership(
    row_ptr: torch.Tensor,
    sorted_cols: torch.Tensor,
    rows: torch.Tensor,
    candidates: torch.Tensor,
    max_row_len: int,
) -> torch.Tensor:
    """``candidates[l] ∈ CSR_row(rows[l])`` for every lane ``l`` (bool).

    ``sorted_cols`` is the row-major column array (ascending within each
    row), ``row_ptr`` delimits the rows; ``rows`` and ``candidates``
    broadcast together."""
    shape = torch.broadcast_shapes(rows.shape, candidates.shape)
    rows_f = rows.expand(shape).reshape(-1).long()
    cand_f = candidates.expand(shape).reshape(-1)
    lo = row_ptr[rows_f]
    hi = row_ptr[rows_f + 1].long()
    pos = lower_bound(sorted_cols, lo, hi, cand_f, max_row_len)
    n = int(sorted_cols.shape[0])
    found = (pos < hi) & (sorted_cols[torch.clamp(pos, max=n - 1)] == cand_f)
    return found.reshape(shape)
