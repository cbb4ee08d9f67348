"""Compulsory work of each operation the benchmark times, from shapes alone,
and the peaks it is held against.

Every count is what the operation's inputs and outputs need, whatever
implements it: each input byte read once, each output byte written once,
and the floating-point operations of the mathematics (a multiply-add is
two). Where the work depends on the data (a sparse product, a batch of
sampled subgraphs), the counts take the sizes these inputs have.

A ``Work`` is (flops, bytes, dtype); ``seconds(work)`` is the least time the
card could take for it: the larger of the operations at the dtype's peak
and the bytes at the memory's peak.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS = {
    "f32": 67e12,     # CUDA cores, outside the tensor cores
    "tf32": 495e12,
    "bf16": 989e12,
    "fp16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
}
PEAK_BYTES_PER_S = 3.35e12   # HBM3
DTYPE_BYTES = {"f32": 4, "tf32": 4, "bf16": 2, "fp16": 2, "fp8": 1, "int8": 1, "i32": 4, "i64": 8}


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    dtype: str = "f32"

    def __add__(self, other: "Work") -> "Work":
        if other.dtype != self.dtype:
            raise ValueError("add Work of one dtype; sum seconds() across dtypes")
        return Work(self.flops + other.flops, self.bytes + other.bytes, self.dtype)

    def __mul__(self, n: float) -> "Work":
        return Work(self.flops * n, self.bytes * n, self.dtype)

    __rmul__ = __mul__


def seconds(work: Work) -> float:
    """Least time for ``work``: max(flops / peak(dtype), bytes / bandwidth)."""
    return max(work.flops / PEAK_FLOPS[work.dtype], work.bytes / PEAK_BYTES_PER_S)


def bound(work: Work) -> str:
    """Which of the two peaks binds ``work``: 'flops' or 'bytes'."""
    return "flops" if work.flops / PEAK_FLOPS[work.dtype] >= work.bytes / PEAK_BYTES_PER_S else "bytes"


def total_seconds(works: Iterable[Work]) -> float:
    return sum(seconds(w) for w in works)


# ---- sparse propagation ---------------------------------------------------

def spmm(num_edges: int, num_dst: int, num_src: int, width: int, gather_dtype: str = "f32") -> Work:
    """One segment sum out[r] = Σ_{e: dst(e)=r} w_e · src[s(e)]: the CSR
    (a 4-byte source id and a 4-byte f32 weight per edge, a 4-byte offset per
    row) and the source table (in the gather dtype) read once, the f32
    output written once; a multiply-add per edge and column."""
    csr = num_edges * 8 + (num_dst + 1) * 4
    table = num_src * width * DTYPE_BYTES[gather_dtype]
    out = num_dst * width * 4
    return Work(2.0 * num_edges * width, csr + table + out, "f32")


def lightgcn_propagation(num_edges: int, num_users: int, num_items: int, width: int,
                         hops: int, gather_dtype: str = "f32") -> Work:
    """The K-hop forward: per hop one segment sum into the users and one
    into the items. The backward of a step is the same work again (the
    adjoint products on the transposed edges)."""
    hop = (spmm(num_edges, num_users, num_items, width, gather_dtype)
           + spmm(num_edges, num_items, num_users, width, gather_dtype))
    return hop * hops


def bpr_rows(batch: int, width: int) -> Work:
    """BPR loss and its gradient at the batch's rows: six [B, D] f32 rows
    read (final and E⁰ rows of the user, positive and negative), their six
    gradient rows written, and ~20 operations a row element (two dots, the
    regulariser, the logistic term and its derivative)."""
    rows = 6 * batch * width * 4
    return Work(20.0 * batch * width, 2 * rows, "f32")


def adam(num_params: int) -> Work:
    """One Adam update over ``num_params`` f32 values: parameter, gradient
    and both moments read, parameter and both moments written; ~12
    operations a value."""
    return Work(12.0 * num_params, 7 * 4 * num_params, "f32")


def lightgcn_train_step(num_edges: int, num_users: int, num_items: int, width: int,
                        hops: int, batch: int, gather_dtype: str = "f32"):
    """A LightGCN train step as a list of Works: the K-hop forward and its
    backward, the BPR rows, Adam over both tables."""
    prop = lightgcn_propagation(num_edges, num_users, num_items, width, hops, gather_dtype)
    return [prop, prop, bpr_rows(batch, width), adam((num_users + num_items) * width)]


# ---- retrieval --------------------------------------------------------------

def masked_mips(users: int, num_items: int, width: int, k: int, excluded: int,
                dtype: str = "f32") -> Work:
    """Top-k maximum inner product over the whole catalog for ``users``
    rows, with ``excluded`` (user, item) pairs masked: the user rows, the
    catalog (once a batch) and the exclusion ids read, k ids and scores a
    user written; a multiply-add per user, item and column."""
    rd = users * width * 4 + num_items * width * DTYPE_BYTES[dtype] + excluded * 4
    wr = users * k * 8
    return Work(2.0 * users * num_items * width, rd + wr, dtype)


# ---- hetero SAGE --------------------------------------------------------------

def linear(rows: int, fan_in: int, fan_out: int, dtype: str = "f32") -> Work:
    """y = x·W (+ b): x, W read, y written; a multiply-add per element."""
    b = DTYPE_BYTES[dtype]
    return Work(2.0 * rows * fan_in * fan_out, b * (rows * fan_in + fan_in * fan_out + rows * fan_out), dtype)


def segment_sum(num_edges: int, num_dst: int, width: int) -> Work:
    """Messages gathered at the edges' sources and summed into their
    destinations: the source rows (at most one a edge) and the edge ids
    read, the destination rows written."""
    return Work(1.0 * num_edges * width, num_edges * (width * 4 + 8) + num_dst * width * 4, "f32")


def sage_forward(num_user_slots: int, num_item_slots: int, num_edges: int, label_slots: int,
                 in_user: int, in_item: int, hidden: int, out: int, gnn_layers: int,
                 dec_dims) -> list:
    """The hetero SAGE encoder-decoder's forward on one batch: per layer two
    segment sums (item→user, user→item) and four linear maps (lin_l of the
    sum, lin_r of the destination), then the decoder MLP over the label
    slots. ``dec_dims`` are the decoder's (fan_in, fan_out) pairs."""
    works = []
    du, di = in_user, in_item
    for layer in range(gnn_layers):
        d_out = out if layer == gnn_layers - 1 else hidden
        works += [segment_sum(num_edges, num_user_slots, di), segment_sum(num_edges, num_item_slots, du),
                  linear(num_user_slots, di, d_out), linear(num_user_slots, du, d_out),
                  linear(num_item_slots, du, d_out), linear(num_item_slots, di, d_out)]
        du = di = d_out
    for fi, fo in dec_dims:
        works.append(linear(label_slots, fi, fo))
    return works


def sage_train_step(forward_works: list, num_params: int) -> list:
    """Forward, backward (twice the forward's operations and bytes: the
    gradient with respect to the inputs and to the weights) and Adam."""
    fwd = list(forward_works)
    bwd = [Work(2 * w.flops, 2 * w.bytes, w.dtype) for w in fwd]
    return fwd + bwd + [adam(num_params)]
