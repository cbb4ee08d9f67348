"""Segment-sum SpMM over destination-sorted edges — the port of the JAX
package's ``ops/spmm_pallas.py`` (kernel A, ``csrc/segsum.cu``, replaces the
Pallas kernel ``_segsum_kernel``).

    out[r] = Σ_{e: dst(e)=r} w_e · table[src(e)]

The plan is one destination-sorted CSR per direction (``row_ptr``, ``src``,
``w``) plus the kernel's work split:

* **Source windows.** The source table is cut into windows of
  ``window_rows`` rows, each sized to a share of the card's L2
  (``L2_WINDOW_SHARE``), and the kernel runs window by window, so a
  window's random row gathers hit L2 instead of device memory. Edges are
  sorted by (row, source) within a row, so the edges of one (row, window)
  are one contiguous sub-range. A source table that fits one window (the
  item table at H&M size) runs as one pass.
* **Pieces.** Every (row, window) sub-range is cut into pieces of at most
  ``edges_per_piece`` edges (an empty row owns one empty piece, so every row
  is written). A piece runs on a warp, or, where an edge's piece holds
  ``SHORT_PIECE_EDGES`` edges or fewer on average, on a group of 8 lanes
  (more for D > 32), several side by side in a warp. A row with one piece
  is written directly; the pieces of any other row write partial rows into
  scratch slots that a second pass sums in a fixed order. No float
  atomics, so results are the same on every run.

The bf16-gather mode (``gather_bf16``, the JAX blocked tier's mode for node
tables of at least 2¹⁹ rows) casts the table to bf16 once per call; each
message is the bf16 product ``bf16(bf16(w)·bf16(x))`` and the messages are
summed in f32.

``pallas_segment_sum`` launches the kernel for tensors on the card and runs
the plain version (``pallas_segment_sum_plain``: ``index_add_`` over the
rows) for tensors on the CPU. The kernel reads rows as float4 vectors, one
lane each, so it takes widths that are a multiple of 4 up to ``MAX_WIDTH``
on a 16-byte aligned table; the wrapper runs any other width in column
blocks of at most ``MAX_WIDTH``, each copied into a fresh zero-padded table
whose width is a multiple of 4, and cuts the padding off the result.

Training: ``propagate_pallas`` is a ``torch.autograd.Function`` whose
backward is the kernel on the other direction's plan (JAX
``spmm_pallas.py:262-286``), and ``lightgcn_propagate_pallas`` carries the
whole K-loop's self-adjoint backward (``ops/multiscale.py``), so a train
step launches the kernel 2·K times forward and 2·K times backward. The
kernel's output has no ``grad_fn`` of its own: gradients reach the E⁰
tables only through these Functions.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build, resolve_device
from ..data.graph import BipartiteGraph
from .multiscale import dense_cotangent, self_adjoint_multiscale

EDGES_PER_PIECE = 512
MAX_WIDTH = 128   # the kernel's lanes cover D/4 four-element vectors, at most 32 of them
L2_WINDOW_SHARE = 0.5   # share of the card's L2 that one source window may fill
SHORT_PIECE_EDGES = 32  # edge-weighted mean piece length up to which pieces run on 8 lanes

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "segsum_launch": [_P] * 6 + [_I64, _P, _P, _I64, _P] + [_I64] * 3 + [_P] * 4,
}


@dataclass
class PallasSegmentPlan:
    """One destination-sorted edge direction, as CSR plus the window and
    piece split."""

    row_ptr: torch.Tensor     # int64 [R+1]
    src: torch.Tensor         # int32 [E] gather ids, sorted by window within a row
    w: torch.Tensor           # f32   [E]
    piece_row: torch.Tensor   # int32 [P] output row of each piece, in launch order
    piece_lo: torch.Tensor    # int64 [P] first edge of each piece
    piece_hi: torch.Tensor    # int64 [P] one past its last edge
    piece_slot: torch.Tensor  # int32 [P] partial slot, -1 = write the row directly
    heavy_row: torch.Tensor   # int32 [H] rows with more than one piece
    heavy_ptr: torch.Tensor   # int32 [H+1] slot range of each heavy row
    num_rows: int = 0
    num_slots: int = 0
    edges_per_piece: int = EDGES_PER_PIECE
    window_rows: int = 0                  # source rows per window (0: one window)
    window_pieces: Tuple[int, ...] = (0, 0)   # piece range of each window, in launch order
    piece_lanes: int = 32                 # lanes a piece runs on: 32, or 8 for short pieces

    @property
    def num_windows(self) -> int:
        return len(self.window_pieces) - 1

    @staticmethod
    def from_edges(
        dst_sorted: np.ndarray,
        src: np.ndarray,
        w: np.ndarray,
        num_rows: int,
        edges_per_piece: int = EDGES_PER_PIECE,
        device="cpu",
        num_src_rows: Optional[int] = None,
        window_rows: int = 0,
    ) -> "PallasSegmentPlan":
        """Plan from edges sorted by destination (host arrays). With
        ``window_rows`` > 0 the source range ``[0, num_src_rows)`` is cut into
        windows of that many rows; edges of a row not sorted by window are
        put in window order (stable) first."""
        dst = np.asarray(dst_sorted, np.int64)
        src = np.asarray(src, np.int64)
        w = np.asarray(w, np.float32)
        if dst.size and np.any(np.diff(dst) < 0):
            raise ValueError("edges must be sorted by destination")
        e = dst.shape[0]
        if num_src_rows is None:
            num_src_rows = int(src.max()) + 1 if e else 1
        wr = int(window_rows) if window_rows and window_rows < num_src_rows else 0
        num_windows = -(-num_src_rows // wr) if wr else 1
        win = src // wr if wr else np.zeros(e, np.int64)
        key = dst * num_windows + win
        if e and np.any(np.diff(key) < 0):
            order = np.argsort(key, kind="stable")
            src, w, win, key = src[order], w[order], win[order], key[order]

        deg = np.bincount(dst, minlength=num_rows)[:num_rows]
        row_ptr = np.zeros(num_rows + 1, np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        # segments: the edges of one (row, window), then one empty segment per empty row
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if e else np.zeros(0, np.int64)
        ends = np.append(starts[1:], e) if e else starts
        empty = np.flatnonzero(deg == 0)
        seg_row = np.r_[dst[starts], empty]
        seg_win = np.r_[win[starts], np.zeros(empty.size, np.int64)]
        seg_lo = np.r_[starts, row_ptr[empty]]
        seg_hi = np.r_[ends, row_ptr[empty]]
        order = np.lexsort((seg_win, seg_row))   # row-major, windows in order
        seg_row, seg_win, seg_lo, seg_hi = (a[order] for a in (seg_row, seg_win, seg_lo, seg_hi))

        c = int(edges_per_piece)
        npieces = np.maximum(1, -(-(seg_hi - seg_lo) // c))
        total = int(npieces.sum())
        seg_of = np.repeat(np.arange(seg_row.size), npieces)
        k_in_seg = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(npieces) - npieces, npieces)
        piece_lo = seg_lo[seg_of] + k_in_seg * c
        piece_hi = np.minimum(piece_lo + c, seg_hi[seg_of])
        piece_row = seg_row[seg_of]
        piece_win = seg_win[seg_of]
        row_pieces = np.bincount(piece_row, minlength=num_rows)
        heavy = row_pieces > 1
        in_heavy = heavy[piece_row]
        # slots numbered row-major, so each heavy row's slots are contiguous in
        # (window, piece) order — the order the combine pass sums them in
        piece_slot = np.where(in_heavy, np.cumsum(in_heavy) - 1, -1)
        heavy_ptr = np.zeros(int(heavy.sum()) + 1, np.int64)
        np.cumsum(row_pieces[heavy], out=heavy_ptr[1:])
        launch = np.argsort(piece_win, kind="stable")   # window by window
        window_pieces = np.searchsorted(piece_win[launch], np.arange(num_windows + 1))

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return PallasSegmentPlan(
            row_ptr=t(row_ptr, np.int64),
            src=t(src, np.int32),
            w=t(w, np.float32),
            piece_row=t(piece_row[launch], np.int32),
            piece_lo=t(piece_lo[launch], np.int64),
            piece_hi=t(piece_hi[launch], np.int64),
            piece_slot=t(piece_slot[launch], np.int32),
            heavy_row=t(np.flatnonzero(heavy), np.int32),
            heavy_ptr=t(heavy_ptr, np.int32),
            num_rows=int(num_rows),
            num_slots=int(heavy_ptr[-1]),
            edges_per_piece=c,
            window_rows=wr,
            window_pieces=tuple(int(x) for x in window_pieces),
            piece_lanes=8 if _short_pieces(piece_hi - piece_lo) else 32,
        )


def _short_pieces(lengths: np.ndarray) -> bool:
    """Whether pieces run on 8 lanes: the mean length of the piece an edge
    lies in is at most ``SHORT_PIECE_EDGES``. Weighting by edges keeps a few
    long pieces among many short ones (a windowed item direction) on warps,
    where 8 lanes would walk them alone."""
    return int((lengths * lengths).sum()) <= SHORT_PIECE_EDGES * int(lengths.sum())


def pallas_segment_sum_plain(
    plan: PallasSegmentPlan, table: torch.Tensor, gather_bf16: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of kernel A (``index_add_`` over the rows); in
    the bf16-gather mode each message is ``bf16(bf16(w)·bf16(x))``."""
    deg = plan.row_ptr[1:] - plan.row_ptr[:-1]
    dst = torch.repeat_interleave(
        torch.arange(plan.num_rows, device=table.device), deg
    )
    src = plan.src.long()
    if gather_bf16:
        bf = torch.bfloat16
        msgs = (plan.w.to(bf)[:, None] * table.to(bf)[src]).float()
    else:
        msgs = plan.w[:, None] * table[src]
    out = torch.zeros((plan.num_rows, table.shape[1]), dtype=torch.float32, device=table.device)
    return out.index_add_(0, dst, msgs)


def pallas_segment_sum(
    plan: PallasSegmentPlan,
    table: torch.Tensor,
    gather_bf16: bool = False,
) -> torch.Tensor:
    """Σ_{e: dst(e)=row} w_e · table[src(e)] for every row — f32 [num_rows, D].
    ``gather_bf16`` gathers bf16 rows (the table is cast once per call).
    A width the kernel takes runs in one launch on the table as it is
    (contiguous and 16-byte aligned, else this raises); any other width
    runs in column blocks (:func:`by_column_blocks`)."""
    if table.device.type == "cpu":
        return pallas_segment_sum_plain(plan, table, gather_bf16)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be f32 [N, D], got {table.dtype} {tuple(table.shape)}")
    if plan.src.device != table.device:
        raise ValueError(f"plan on {plan.src.device}, table on {table.device}")
    return by_column_blocks(plan, table, gather_bf16, _segsum_launch)


def by_column_blocks(plan: PallasSegmentPlan, table: torch.Tensor, gather_bf16: bool,
                     segment_sum) -> torch.Tensor:
    """``segment_sum(plan, table, gather_bf16)`` where the kernel takes the
    width (a multiple of 4 up to ``MAX_WIDTH``); else ``segment_sum`` over
    column blocks of at most ``MAX_WIDTH`` columns, each copied into a fresh
    zero-padded table whose width is a multiple of 4, with the padding cut
    off the result. Columns are independent, so the result is the one
    full-width call's."""
    n, d = table.shape
    if d % 4 == 0 and 4 <= d <= MAX_WIDTH:
        return segment_sum(plan, table, gather_bf16)
    out = table.new_empty((plan.num_rows, d))
    for c in range(0, d, MAX_WIDTH):
        w = min(MAX_WIDTH, d - c)
        block = table.new_zeros((n, -(-w // 4) * 4))
        block[:, :w] = table[:, c:c + w]
        out[:, c:c + w] = segment_sum(plan, block, gather_bf16)[:, :w]
    return out


def _segsum_launch(plan: PallasSegmentPlan, table: torch.Tensor, gather_bf16: bool) -> torch.Tensor:
    """One launch of kernel A on a table of a width it takes."""
    d = int(table.shape[1])
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError(
            f"the segment-sum kernel takes a contiguous, 16-byte aligned table, got "
            f"D={d} with strides {table.stride()}"
        )
    if gather_bf16:
        table = table.to(torch.bfloat16)
    out = torch.empty((plan.num_rows, d), dtype=torch.float32, device=table.device)
    partial = torch.empty((max(plan.num_slots, 1), d), dtype=torch.float32, device=table.device)
    windows = (ctypes.c_int64 * len(plan.window_pieces))(*plan.window_pieces)
    lib = _build.load("segsum", _SIGNATURES)
    rc = lib.segsum_launch(
        plan.src.data_ptr(), plan.w.data_ptr(), plan.piece_row.data_ptr(),
        plan.piece_lo.data_ptr(), plan.piece_hi.data_ptr(), plan.piece_slot.data_ptr(),
        plan.num_windows, ctypes.cast(windows, _P),
        plan.heavy_row.data_ptr(), int(plan.heavy_row.shape[0]), plan.heavy_ptr.data_ptr(),
        d, int(gather_bf16), plan.piece_lanes,
        table.data_ptr(), partial.data_ptr(), out.data_ptr(), _build.stream_ptr(table.device),
    )
    _build.check(rc, "segsum_launch")
    _build.launches["segsum"] += 1
    return out


@dataclass
class PallasGraph:
    """Both diffusion directions as segment-sum plans; ``gather_bf16``
    switches both directions' gathers to bf16."""

    to_user: PallasSegmentPlan   # dst=user, src=item
    to_item: PallasSegmentPlan   # dst=item, src=user
    gather_bf16: bool = False

    @staticmethod
    def from_graph(
        g: BipartiteGraph,
        edges_per_piece: int = EDGES_PER_PIECE,
        width: int = 0,
        gather_bf16: bool = False,
        l2_bytes: Optional[int] = None,
    ) -> "PallasGraph":
        """Plans from a graph's host edge arrays, on the graph's device.

        Source windows hold ``L2_WINDOW_SHARE`` of ``l2_bytes`` in rows of
        ``width`` elements (2 bytes each with ``gather_bf16``, else 4).
        ``l2_bytes`` defaults to the card's L2 for a graph on the card and
        to 0 (one window) for a CPU graph; ``width`` 0 means one window."""
        return PallasGraph._from_sorted(g.host_arrays(), g.num_users, g.num_items, g.device,
                                        edges_per_piece, width, gather_bf16, l2_bytes)

    @staticmethod
    def from_host_edges(
        user_idx: np.ndarray,
        item_idx: np.ndarray,
        num_users: int,
        num_items: int,
        edges_per_piece: int = EDGES_PER_PIECE,
        width: int = 0,
        gather_bf16: bool = False,
        l2_bytes: Optional[int] = None,
        device="cuda",
    ) -> "PallasGraph":
        """Plans straight from host (user, item) edge arrays, with no
        :class:`BipartiteGraph` (JAX ``spmm_pallas.py:225-251``): the
        symmetric normalisation 1/√(deg(u)·deg(i)) and both sort orders in
        numpy, as ``BipartiteGraph.from_edges`` computes them, so the plans
        equal :meth:`from_graph`'s for the same edges."""
        dev = resolve_device(device)
        user_idx = np.asarray(user_idx, np.int64)
        item_idx = np.asarray(item_idx, np.int64)
        du = np.bincount(user_idx, minlength=num_users)[user_idx].astype(np.float64)
        di = np.bincount(item_idx, minlength=num_items)[item_idx].astype(np.float64)
        w = (1.0 / np.sqrt(np.maximum(du * di, 1.0))).astype(np.float32)
        um = np.lexsort((item_idx, user_idx))
        im = np.lexsort((user_idx, item_idx))
        arrays = (user_idx[um], item_idx[um], w[um], user_idx[im], item_idx[im], w[im])
        return PallasGraph._from_sorted(arrays, num_users, num_items, dev, edges_per_piece,
                                        width, gather_bf16, l2_bytes)

    @staticmethod
    def _from_sorted(arrays, num_users, num_items, device, edges_per_piece, width,
                     gather_bf16, l2_bytes) -> "PallasGraph":
        """Plans from (user, item, w) in user-major order and again in
        item-major order (host arrays), on ``device``."""
        if l2_bytes is None:
            l2_bytes = (torch.cuda.get_device_properties(device).L2_cache_size
                        if device.type == "cuda" else 0)
        row_bytes = int(width) * (2 if gather_bf16 else 4)
        window_rows = int(L2_WINDOW_SHARE * l2_bytes) // row_bytes if row_bytes else 0
        eu, ei, ew, eu_im, ei_im, ew_im = arrays
        return PallasGraph(
            to_user=PallasSegmentPlan.from_edges(
                eu, ei, ew, num_users, edges_per_piece, device,
                num_src_rows=num_items, window_rows=window_rows,
            ),
            to_item=PallasSegmentPlan.from_edges(
                ei_im, eu_im, ew_im, num_items, edges_per_piece, device,
                num_src_rows=num_users, window_rows=window_rows,
            ),
            gather_bf16=bool(gather_bf16),
        )


class _PropagatePallas(torch.autograd.Function):
    """(Ã·item, Ãᵀ·user) with backward (Ã·g_item, Ãᵀ·g_user): each
    direction's transpose is the other direction's plan (JAX
    ``spmm_pallas.py:273-286``), run in the operand's gather mode."""

    @staticmethod
    def forward(ctx, pg, user_emb, item_emb):
        ctx.pg = pg
        return (
            pallas_segment_sum(pg.to_user, item_emb, pg.gather_bf16),
            pallas_segment_sum(pg.to_item, user_emb, pg.gather_bf16),
        )

    @staticmethod
    def backward(ctx, g_new_user, g_new_item):
        pg = ctx.pg
        # new_user = Ã·item, new_item = Ãᵀ·user ⇒ ḡ_user = Ã·ḡ_new_item, ḡ_item = Ãᵀ·ḡ_new_user
        g_user = pallas_segment_sum(pg.to_user, dense_cotangent(g_new_item), pg.gather_bf16)
        g_item = pallas_segment_sum(pg.to_item, dense_cotangent(g_new_user), pg.gather_bf16)
        return None, g_user, g_item


def propagate_pallas(
    pg: PallasGraph, user_emb: torch.Tensor, item_emb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``spmm.propagate_bipartite`` on the segment-sum plans,
    differentiable through kernel A (:class:`_PropagatePallas`)."""
    return _PropagatePallas.apply(pg, user_emb, item_emb)


def lightgcn_propagate_pallas(
    pg: PallasGraph,
    user_emb0: torch.Tensor,
    item_emb0: torch.Tensor,
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-iteration multi-scale mean (contract of ``spmm.lightgcn_propagate``)
    through kernel A: 2·K launches, and 2·K more in its backward, the whole
    loop's self-adjoint VJP (JAX ``spmm_pallas.py:289-301``)."""
    return self_adjoint_multiscale(propagate_pallas, pg, user_emb0, item_emb0, num_iterations)
