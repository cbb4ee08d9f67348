"""Row-sharded embedding tables with cross-shard lookup — the port of the JAX
package's ``ops/embedding.py``.

Each rank of the ``model`` axis holds a contiguous row block of the table.
For an id batch that every rank holds alike, each rank gathers the ids it
owns (the others give zeros) and one ``psum`` over ``model`` assembles the
whole [..., D] result: an all-reduce of the activation block, the usual
exchange when B·D is far below the table's size. The gradient lands on the
owning shard only: the gather's backward is a sorted segment sum
(``ops/sorted_sum``), so repeated ids add up in a fixed order, and the
psum's backward is the identity (every rank consumes the result alike).
"""
from __future__ import annotations

import torch

from ..parallel.collectives import psum
from ..parallel.mesh import MODEL_AXIS, Mesh
from .sorted_sum import gather_rows


def shard_table(mesh: Mesh, table: torch.Tensor) -> torch.Tensor:
    """This rank's row block of a [N, D] table (N divides the model axis), on
    the mesh's device."""
    lo, hi = mesh.row_range(table.shape[0])
    return table[lo:hi].to(mesh.device).contiguous()


def sharded_embedding_lookup(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``full_table[ids]`` from this rank's row block ``table`` [N/p, D] of a
    table sharded over ``model``; ``ids`` (int [...]) is the same on every
    rank, and so is the result [..., D]. Differentiable; on a 1-wide model
    axis it is a plain gather."""
    shard_rows = table.shape[0]
    offset = mesh.rank(MODEL_AXIS) * shard_rows
    local = ids.long() - offset
    in_range = (local >= 0) & (local < shard_rows)
    rows = gather_rows(table, torch.clamp(local, 0, shard_rows - 1))
    if mesh.size(MODEL_AXIS) == 1:
        return rows
    rows = torch.where(in_range[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return psum(rows, mesh, MODEL_AXIS)
