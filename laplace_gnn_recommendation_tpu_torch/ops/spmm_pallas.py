"""Segment-sum SpMM over destination-sorted edges — the port of the JAX
package's ``ops/spmm_pallas.py`` (kernel A, ``csrc/segsum.cu``, replaces the
Pallas kernel ``_segsum_kernel``).

    out[r] = Σ_{e: dst(e)=r} w_e · table[src(e)]

The plan is one destination-sorted CSR per direction (``row_ptr``, ``src``,
``w``) plus the kernel's work split: every row owns ``ceil(deg / chunk)``
pieces of at most ``chunk`` edges (an empty row one empty piece). A row with
one piece is written directly by its warp; the pieces of a heavier row write
partial rows into scratch slots that a second pass sums in piece order.
Skewed graphs need this: at H&M shape the most popular item row holds
hundreds of thousands of edges, which one warp would walk alone. No float
atomics, so results are the same on every run.

``pallas_segment_sum`` launches the kernel for tensors on the card (widths
a multiple of 4 up to 128; others raise) and runs the plain version
(``pallas_segment_sum_plain``: ``index_add_`` over the rows) for tensors on
the CPU.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import _build
from ..data.graph import BipartiteGraph
from .multiscale import multiscale_loop

EDGES_PER_PIECE = 512
MAX_WIDTH = 128   # the kernel's lanes cover D/4 float4s, at most 32 of them

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "segsum_launch": [_P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _I64, _P, _I64, _P, _P, _P],
}


@dataclass
class PallasSegmentPlan:
    """One destination-sorted edge direction, as CSR plus the piece split."""

    row_ptr: torch.Tensor     # int64 [R+1]
    src: torch.Tensor         # int32 [E] gather ids
    w: torch.Tensor           # f32   [E]
    piece_row: torch.Tensor   # int32 [P] output row of each piece
    piece_lo: torch.Tensor    # int64 [P] first edge of each piece
    piece_slot: torch.Tensor  # int32 [P] partial slot, -1 = write the row directly
    heavy_row: torch.Tensor   # int32 [H] rows with more than one piece
    heavy_ptr: torch.Tensor   # int32 [H+1] slot range of each heavy row
    num_rows: int = 0
    num_slots: int = 0
    edges_per_piece: int = EDGES_PER_PIECE

    @staticmethod
    def from_edges(
        dst_sorted: np.ndarray,
        src: np.ndarray,
        w: np.ndarray,
        num_rows: int,
        edges_per_piece: int = EDGES_PER_PIECE,
        device="cpu",
    ) -> "PallasSegmentPlan":
        """Plan from edges sorted by destination (host arrays)."""
        dst_sorted = np.asarray(dst_sorted, np.int64)
        if dst_sorted.size and np.any(np.diff(dst_sorted) < 0):
            raise ValueError("edges must be sorted by destination")
        deg = np.bincount(dst_sorted, minlength=num_rows)[:num_rows]
        row_ptr = np.zeros(num_rows + 1, np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        c = int(edges_per_piece)
        npieces = np.maximum(1, -(-deg // c))
        total = int(npieces.sum())
        piece_row = np.repeat(np.arange(num_rows, dtype=np.int64), npieces)
        first = np.cumsum(npieces) - npieces
        k_in_row = np.arange(total, dtype=np.int64) - np.repeat(first, npieces)
        piece_lo = row_ptr[piece_row] + k_in_row * c
        heavy = npieces > 1
        in_heavy = heavy[piece_row]
        piece_slot = np.where(in_heavy, np.cumsum(in_heavy) - 1, -1)
        heavy_ptr = np.zeros(int(heavy.sum()) + 1, np.int64)
        np.cumsum(npieces[heavy], out=heavy_ptr[1:])

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return PallasSegmentPlan(
            row_ptr=t(row_ptr, np.int64),
            src=t(src, np.int32),
            w=t(w, np.float32),
            piece_row=t(piece_row, np.int32),
            piece_lo=t(piece_lo, np.int64),
            piece_slot=t(piece_slot, np.int32),
            heavy_row=t(np.flatnonzero(heavy), np.int32),
            heavy_ptr=t(heavy_ptr, np.int32),
            num_rows=int(num_rows),
            num_slots=int(heavy_ptr[-1]),
            edges_per_piece=c,
        )


def pallas_segment_sum_plain(plan: PallasSegmentPlan, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A (``index_add_`` over the rows)."""
    deg = plan.row_ptr[1:] - plan.row_ptr[:-1]
    dst = torch.repeat_interleave(
        torch.arange(plan.num_rows, device=table.device), deg
    )
    msgs = plan.w[:, None] * table[plan.src.long()]
    out = torch.zeros((plan.num_rows, table.shape[1]), dtype=torch.float32, device=table.device)
    return out.index_add_(0, dst, msgs)


def pallas_segment_sum(plan: PallasSegmentPlan, table: torch.Tensor) -> torch.Tensor:
    """Σ_{e: dst(e)=row} w_e · table[src(e)] for every row — f32 [num_rows, D]."""
    if table.device.type == "cpu":
        return pallas_segment_sum_plain(plan, table)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(
            f"table must be contiguous f32 [N, D], got {table.dtype} {tuple(table.shape)}"
        )
    if plan.src.device != table.device:
        raise ValueError(f"plan on {plan.src.device}, table on {table.device}")
    d = int(table.shape[1])
    if d % 4 or not 4 <= d <= MAX_WIDTH or table.data_ptr() % 16:
        raise ValueError(
            f"the segment-sum kernel takes widths that are a multiple of 4 up to "
            f"{MAX_WIDTH} on a 16-byte aligned table, got D={d}"
        )
    out = torch.empty((plan.num_rows, d), dtype=torch.float32, device=table.device)
    partial = torch.empty((max(plan.num_slots, 1), d), dtype=torch.float32, device=table.device)
    lib = _build.load("segsum", _SIGNATURES)
    rc = lib.segsum_launch(
        plan.row_ptr.data_ptr(), plan.src.data_ptr(), plan.w.data_ptr(),
        plan.piece_row.data_ptr(), plan.piece_lo.data_ptr(), plan.piece_slot.data_ptr(),
        int(plan.piece_row.shape[0]), plan.edges_per_piece,
        plan.heavy_row.data_ptr(), plan.heavy_ptr.data_ptr(), int(plan.heavy_row.shape[0]),
        table.data_ptr(), d, partial.data_ptr(), out.data_ptr(),
        _build.stream_ptr(table.device),
    )
    _build.check(rc, "segsum_launch")
    _build.launches["segsum"] += 1
    return out


@dataclass
class PallasGraph:
    """Both diffusion directions as segment-sum plans."""

    to_user: PallasSegmentPlan   # dst=user, src=item
    to_item: PallasSegmentPlan   # dst=item, src=user

    @staticmethod
    def from_graph(
        g: BipartiteGraph, edges_per_piece: int = EDGES_PER_PIECE
    ) -> "PallasGraph":
        """Plans from a graph's host edge arrays, on the graph's device."""
        eu, ei, ew, eu_im, ei_im, ew_im = g.host_arrays()
        return PallasGraph(
            to_user=PallasSegmentPlan.from_edges(
                eu, ei, ew, g.num_users, edges_per_piece, g.device
            ),
            to_item=PallasSegmentPlan.from_edges(
                ei_im, eu_im, ew_im, g.num_items, edges_per_piece, g.device
            ),
        )


def propagate_pallas(
    pg: PallasGraph, user_emb: torch.Tensor, item_emb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``spmm.propagate_bipartite`` on the segment-sum plans."""
    return (
        pallas_segment_sum(pg.to_user, item_emb),
        pallas_segment_sum(pg.to_item, user_emb),
    )


def lightgcn_propagate_pallas(
    pg: PallasGraph,
    user_emb0: torch.Tensor,
    item_emb0: torch.Tensor,
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-iteration multi-scale mean (contract of ``spmm.lightgcn_propagate``)
    through kernel A: 2·K launches."""
    return multiscale_loop(propagate_pallas, pg, user_emb0, item_emb0, num_iterations)
