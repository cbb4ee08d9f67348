"""Row gathers and segment sums in a fixed order, so one batch's gradients
repeat bit for bit on the card (shared by ``models/sage.py`` and
``models/pinsage.py``).

``table[idx]``'s own backward walks each run of repeated indices in one warp
(132 ms of a 135 ms ranking step on an H100, over rows repeated hundreds of
times), and ``index_add_`` / ``F.embedding``'s backward sum in the order of
their float atomics, which changes from run to run. Here a
:class:`SumPlan` sorts the indices once and sums with two
``segment_reduce`` passes; :func:`gather_rows` takes it as its backward and
:class:`SegmentSum` as its forward. In the JAX package these are plain XLA
gathers and ``jax.ops.segment_sum``, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

PIECE_ROWS = 32   # rows one thread of the first summing pass adds up


class SumPlan:
    """How to add rows of a [len(idx), D] tensor by ``idx`` into [num_rows,
    D] in a fixed order, so the same inputs give the same bits. The indices
    are sorted stably; each index's run is cut into pieces of at most
    ``PIECE_ROWS`` rows, one ``segment_reduce`` sums every piece and a
    second sums each row's pieces. A run of hundreds of repeats is then no
    longer one thread's or one warp's serial walk, which took 2-25 ms a
    call on an H100 (64-value feature tables, popular items' edges), and no
    float atomics are used. Built once per index tensor: a batch's edge
    ends serve every layer, forward and backward.

    When the table has more rows than there are indices (an id table of
    every item, gathered at a batch's slots), the sums run over the
    indices' distinct values, in sorted order, and are then copied into
    place: ``segment_reduce`` over 10⁵ mostly empty segments took ~4 ms a
    call on an H100."""

    def __init__(self, idx: torch.Tensor, num_rows: int):
        self.idx = idx.reshape(-1)
        self.num_rows = num_rows
        n, dev = self.idx.shape[0], self.idx.device
        sorted_idx, self.order = torch.sort(self.idx, stable=True)
        key, self.sum_rows, self.rows = sorted_idx, num_rows, None
        if num_rows > n:
            # key: the rank of each sorted index among the distinct values;
            # rows: the table row of each rank (spare ranks → a dropped row).
            # Duplicate writes of the scatter carry one value.
            new = torch.ones(n, dtype=torch.long, device=dev)
            new[1:] = (sorted_idx[1:] != sorted_idx[:-1]).long()
            key, self.sum_rows = torch.cumsum(new, 0) - 1, n
            self.rows = torch.full((n,), num_rows, dtype=torch.long, device=dev).scatter_(
                0, key, sorted_idx.long())
        rows = self.sum_rows
        counts = torch.searchsorted(key, torch.arange(rows + 1, device=dev)).diff()
        pieces = (counts + PIECE_ROWS - 1) // PIECE_ROWS
        # piece slots: row r owns [end_r - pieces_r, end_r); m slots bound them all
        m = n // PIECE_ROWS + rows
        end = torch.cumsum(pieces, 0)
        slot = torch.arange(m, device=dev)
        row = torch.searchsorted(end, slot, right=True).clamp_max(rows - 1)
        first = slot - (end - pieces)[row]
        self.lengths = torch.where(
            slot < end[-1], torch.clamp(counts[row] - first * PIECE_ROWS, 0, PIECE_ROWS), 0)
        # one extra segment takes the unused slots, and is dropped
        self.per_row = torch.cat([pieces, (m - end[-1]).reshape(1)])

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        v = values.reshape(self.order.shape[0], values.shape[-1]).index_select(0, self.order)
        partial = torch.segment_reduce(v, "sum", lengths=self.lengths, unsafe=True)
        out = torch.segment_reduce(partial, "sum", lengths=self.per_row, unsafe=True)
        out = out[: self.sum_rows]
        if self.rows is None:
            return out
        # spare ranks sum nothing (0) and all land on the dropped row
        full = out.new_zeros((self.num_rows + 1, out.shape[1])).index_copy_(0, self.rows, out)
        return full[: self.num_rows]


class Rows(torch.autograd.Function):
    """``table[idx]`` whose backward is a :class:`SumPlan` sum of the
    gradient."""

    @staticmethod
    def forward(ctx, table, idx, plan):
        ctx.save_for_backward(idx)
        ctx.num_rows, ctx.plan = table.shape[0], plan
        return table.index_select(0, idx.reshape(-1)).view(*idx.shape, table.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        plan = ctx.plan if ctx.plan is not None else SumPlan(idx, ctx.num_rows)
        return plan.sum(grad), None, None


class SegmentSum(torch.autograd.Function):
    """``SegmentSum.apply(values, plan)``: rows of ``values`` [len(plan.idx),
    D] summed by ``plan.idx`` into [plan.num_rows, D]
    (``jax.ops.segment_sum``), with the gather as its backward."""

    @staticmethod
    def forward(ctx, values, plan):
        ctx.plan = plan
        return plan.sum(values)

    @staticmethod
    def backward(ctx, grad):
        return grad.index_select(0, ctx.plan.idx), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor, plan: Optional[SumPlan] = None):
    """``table[idx]`` for a 2-D ``table`` that takes a gradient; ``plan``, a
    :class:`SumPlan` of ``idx`` over the table's rows, if one is built (else
    the backward builds it)."""
    return Rows.apply(table, idx, plan)
