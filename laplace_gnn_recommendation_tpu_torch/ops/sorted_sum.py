"""Row gathers and segment sums in a fixed order, so one batch's gradients
repeat bit for bit on the card (shared by ``models/sage.py``,
``models/pinsage.py`` and ``ops/embedding.py``).

``table[idx]``'s own backward walks each run of repeated indices in one warp
(132 ms of a 135 ms ranking step on an H100, over rows repeated hundreds of
times), and ``index_add_`` / ``F.embedding``'s backward sum in the order of
their float atomics, which changes from run to run. Here a
:class:`SumPlan` sorts the indices once and fixes the order of every sum
over them; :func:`gather_rows` takes it as its backward and
:class:`SegmentSum` as its forward, and :class:`EdgeSums` fuses a gather
with the sum over one edge list in both directions (:class:`EdgeSum`). On
the card each sum is one launch of ``csrc/sorted_sum.cu``, which reads the
rows through the plan's order; :func:`sorted_sum_plain` is its plain
version and the path of CPU tensors. In the JAX package these are plain
XLA gathers and ``jax.ops.segment_sum``, outside any Pallas kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..utils.profiling import tracer

PIECE_ROWS = 32   # entries of a row summed as one piece before the pieces are added

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {"sorted_sum_launch": [_P, _I64, _P, _I64, _P, _P, _I64, _I64, _P, _P, _P]}


class SumPlan:
    """How to add rows by ``idx`` into [num_rows, D] in a fixed order, so the
    same inputs give the same bits. The indices are sorted stably; each
    index's run is cut into pieces of at most ``PIECE_ROWS`` entries, every
    piece is summed left to right and then each row's pieces are. A run of
    hundreds of repeats is then no longer one thread's or one warp's serial
    walk, which took 2-25 ms a call on an H100 (64-value feature tables,
    popular items' edges), and no float atomics are used. Built once per
    index tensor: a batch's edge ends serve every layer, forward and
    backward.

    ``valid`` (bool, shaped like ``idx``) leaves entries out: they are
    sorted past the last row and no sum visits them (a batch's pad edges).

    When the table has more rows than there are indices (an id table of
    every item, gathered at a batch's slots), the sums run over the
    indices' distinct values, in sorted order, and are then copied into
    place: 10⁵ mostly empty segments took ~4 ms a call on an H100."""

    def __init__(self, idx: torch.Tensor, num_rows: int, valid: Optional[torch.Tensor] = None):
        self.idx = idx.reshape(-1)
        self.num_rows = num_rows
        n, dev = self.idx.shape[0], self.idx.device
        key = self.idx if valid is None else torch.where(valid.reshape(-1), self.idx, num_rows)
        sorted_idx, self.order = torch.sort(key, stable=True)
        key, self.sum_rows, self.rows = sorted_idx, num_rows, None
        if num_rows > n:
            # key: the rank of each sorted index among the distinct values;
            # rows: the table row of each rank (spare ranks and the masked
            # entries' rank → a dropped row). Duplicate writes of the
            # scatter carry one value.
            new = torch.ones(n, dtype=torch.long, device=dev)
            new[1:] = (sorted_idx[1:] != sorted_idx[:-1]).long()
            rank, self.sum_rows = torch.cumsum(new, 0) - 1, n
            self.rows = torch.full((n,), num_rows, dtype=torch.long, device=dev).scatter_(
                0, rank, sorted_idx.long())
            key = rank if valid is None else torch.where(sorted_idx < num_rows, rank, n)
        # row r's entries are the sorted positions [start[r], start[r + 1]);
        # masked entries lie past start[-1]
        self.start = torch.searchsorted(key, torch.arange(self.sum_rows + 1, device=dev))
        self._order32 = self._segments = self._pieces = None

    @property
    def order32(self) -> torch.Tensor:
        """``order`` as int32, the kernel's index type."""
        if self._order32 is None:
            self._order32 = self.order.int()
        return self._order32

    def segments(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The plain version's two ``segment_reduce`` length lists: one slot a
        piece (row r owns [end_r - pieces_r, end_r) of n // PIECE_ROWS +
        rows slots, which bound them all); and each row's count of slots,
        then one extra segment that takes the unused slots, and is
        dropped."""
        if self._segments is None:
            rows, n = self.sum_rows, self.order.shape[0]
            counts = self.start.diff()
            pieces = (counts + PIECE_ROWS - 1) // PIECE_ROWS
            m = n // PIECE_ROWS + rows
            end = torch.cumsum(pieces, 0)
            slot = torch.arange(m, device=counts.device)
            row = torch.searchsorted(end, slot, right=True).clamp_max(rows - 1)
            first = slot - (end - pieces)[row]
            lengths = torch.where(
                slot < end[-1], torch.clamp(counts[row] - first * PIECE_ROWS, 0, PIECE_ROWS), 0)
            self._segments = (lengths, torch.cat([pieces, (m - end[-1]).reshape(1)]))
        return self._segments

    def pieces(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The kernel's work list, int32 [n // PIECE_ROWS + rows, 4]: one item
        a piece, in row order, (row, first entry, end entry, scratch slot);
        an empty row owns one empty piece, so every row is written; a row of
        one piece has slot -1 (it writes its output row), the pieces of a
        longer row have their own item numbers as slots; unused items have
        row -1. And int32 [rows]: each row's end in the list."""
        if self._pieces is None:
            rows, n = self.sum_rows, self.order.shape[0]
            if n + rows >= 2 ** 31:
                raise ValueError(f"the sorted-sum kernel takes under 2**31 entries, got {n}")
            counts = self.start.diff()
            pieces = torch.clamp_min((counts + PIECE_ROWS - 1) // PIECE_ROWS, 1)
            end = torch.cumsum(pieces, 0)
            item = torch.arange(n // PIECE_ROWS + rows, device=counts.device)
            row = torch.searchsorted(end, item, right=True)
            used = row < rows
            row = row.clamp_max(rows - 1)
            lo = self.start[row] + (item - (end - pieces)[row]) * PIECE_ROWS
            hi = torch.minimum(lo + PIECE_ROWS, self.start[row + 1])
            slot = torch.where(pieces[row] > 1, item, -1)
            meta = torch.stack([torch.where(used, row, -1), lo, hi, slot], 1).int()
            self._pieces = (meta, end.int())
        return self._pieces

    def gather_sum(self, table: torch.Tensor, reads: torch.Tensor) -> torch.Tensor:
        """[num_rows, D]: row r is the sum, in the plan's order, of
        ``table[reads[k]]`` over row r's sorted entries k (``reads`` lists a
        table row for each sorted position). On the card one kernel launch,
        else the plain version."""
        table = table.contiguous()
        sum_ = sorted_sum_kernel if table.is_cuda else sorted_sum_plain
        out = sum_(self, table, reads)
        if self.rows is None:
            return out
        # spare ranks sum nothing (0) and all land on the dropped row
        full = out.new_zeros((self.num_rows + 1, out.shape[1])).index_copy_(0, self.rows, out)
        return full[: self.num_rows]

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """Rows of ``values`` [len(idx), D] added by ``idx``."""
        return self.gather_sum(values.reshape(self.order.shape[0], values.shape[-1]), self.order32)


def sorted_sum_plain(plan: SumPlan, table: torch.Tensor, reads: torch.Tensor) -> torch.Tensor:
    """:meth:`SumPlan.gather_sum` before the rows are put in place, in plain
    PyTorch: the rows of the unmasked entries gathered in sorted order, then
    two ``segment_reduce`` passes (each adds a segment left to right from
    0), pieces then rows. On the card it reads the unmasked count back."""
    lengths, per_row = plan.segments()
    v = table.index_select(0, reads[: int(plan.start[-1])])
    partial = torch.segment_reduce(v, "sum", lengths=lengths, unsafe=True)
    out = torch.segment_reduce(partial, "sum", lengths=per_row, unsafe=True)
    return out[: plan.sum_rows]


def sorted_sum_kernel(plan: SumPlan, table: torch.Tensor, reads: torch.Tensor) -> torch.Tensor:
    """:func:`sorted_sum_plain` in one launch of ``csrc/sorted_sum.cu``: f32
    tables only, ``reads`` int32 on the table's device."""
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"the sorted-sum kernel takes a 2-D f32 table, got {table.dtype} "
                         f"of shape {tuple(table.shape)}")
    if reads.dtype != torch.int32 or reads.shape != plan.order.shape or not reads.is_contiguous():
        raise ValueError(f"the sorted-sum kernel reads int32 indices, one a sorted entry "
                         f"({plan.order.shape[0]}), got {reads.dtype} {tuple(reads.shape)}")
    if reads.device != table.device or plan.order.device != table.device:
        raise ValueError("the sorted-sum kernel's table, indices and plan share one device")
    meta, row_end = plan.pieces()
    d = int(table.shape[1])
    out = torch.empty((plan.sum_rows, d), dtype=torch.float32, device=table.device)
    # one slot an item; only the pieces of rows with more than one write theirs
    partial = torch.empty((meta.shape[0], d), dtype=torch.float32, device=table.device)
    vec = d % 4 == 0 and table.data_ptr() % 16 == 0
    lib = _build.load("sorted_sum", _SIGNATURES)
    rc = lib.sorted_sum_launch(
        meta.data_ptr(), int(meta.shape[0]), row_end.data_ptr(), plan.sum_rows,
        reads.data_ptr(), table.data_ptr(), d, int(vec), partial.data_ptr(), out.data_ptr(),
        _build.stream_ptr(table.device),
    )
    _build.check(rc, "sorted_sum_launch")
    _build.launches["sorted_sum"] += 1
    tracer.count("sorted_sum.kernel_sums")
    return out


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


class EdgeSum(torch.autograd.Function):
    """``EdgeSum.apply(table, out_plan, out_reads, in_plan, in_reads)``:
    [out_plan.num_rows, D], row r the sum of ``table[in_key[e]]`` over the
    valid edges e whose out key is r, in ``out_plan``'s order, where
    ``out_reads`` is ``in_key`` in that order. No [E, D] message tensor is
    built. The backward is the same sum with the plans swapped."""

    @staticmethod
    def forward(ctx, table, out_plan, out_reads, in_plan, in_reads):
        ctx.plans = (out_plan, out_reads, in_plan, in_reads)
        return out_plan.gather_sum(table, out_reads)

    @staticmethod
    def backward(ctx, grad):
        out_plan, out_reads, in_plan, in_reads = ctx.plans
        return EdgeSum.apply(grad, in_plan, in_reads, out_plan, out_reads), None, None, None, None


class EdgeSums:
    """The sums over one edge list (ends ``key_a`` into ``rows_a`` rows and
    ``key_b`` into ``rows_b``) in both directions: ``to_a(x_b)`` [rows_a,
    D] adds, for each a, the rows of ``x_b`` at the b ends of its valid
    edges, and ``to_b(x_a)`` the other way; each is the other's backward.
    Built once per edge list, for every layer."""

    def __init__(self, key_a, rows_a: int, key_b, rows_b: int,
                 valid: Optional[torch.Tensor] = None):
        self.plan_a = SumPlan(key_a, rows_a, valid)
        self.plan_b = SumPlan(key_b, rows_b, valid)
        # the row of the other side that each sorted entry reads
        self.reads_a = key_b.reshape(-1).index_select(0, self.plan_a.order).int()
        self.reads_b = key_a.reshape(-1).index_select(0, self.plan_b.order).int()

    def to_a(self, x_b: torch.Tensor) -> torch.Tensor:
        return EdgeSum.apply(x_b, self.plan_a, self.reads_a, self.plan_b, self.reads_b)

    def to_b(self, x_a: torch.Tensor) -> torch.Tensor:
        return EdgeSum.apply(x_a, self.plan_b, self.reads_b, self.plan_a, self.reads_a)


def gather_rows(table: torch.Tensor, idx: torch.Tensor, plan: Optional[SumPlan] = None):
    """``table[idx]`` for a 2-D ``table`` that takes a gradient; ``plan``, a
    :class:`SumPlan` of ``idx`` over the table's rows, if one is built (else
    the backward builds it)."""
    return Rows.apply(table, idx, plan)
