"""Collectives over one mesh axis, written out by hand where XLA derives them
from sharding annotations in the JAX package.

Three of them carry gradients, each a ``torch.autograd.Function``:

* :func:`all_gather_rows` — the row blocks of a table sharded over
  ``model``, concatenated in rank order (``lax.all_gather(tiled=True)``).
  Its consumer differs per rank (each shard's edges read the whole table),
  so its backward is the reduce-scatter (sum) of the cotangents.
* :func:`psum` — an all-reduce (sum) over an axis, for results that every
  rank of the axis then uses alike (the cross-shard lookup). The loss
  downstream is computed once per rank of the axis, each the same, so the
  cotangent of the sum is the cotangent of each term: its backward is the
  identity.
* :func:`sync_grads` — the identity forward, an all-reduce (sum) of the
  cotangent over ``data`` backward: applied to a parameter before its use
  on a data-parallel slice, it makes the slice's gradient the global one,
  as ``P(DATA_AXIS)`` on the batch does for the JAX step.

Transport: NCCL for ranks on cards, gloo for the CPU; two ranks that share
one card (NCCL refuses that) run gloo on its CUDA tensors. Gloo took every
call used here on CUDA tensors itself (torch 2.11 with CUDA 12.8, two ranks
on one H100: all-reduce, all-gather and reduce-scatter into one tensor,
barrier, object all-gather), so no call is staged through host memory.
``transports`` counts the tensor collectives issued, by backend and by the
device of the tensors handed to it.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

# The collective entry points under the names of this torch, or the older ones.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

transports: Counter = Counter()   # "backend/device type" -> tensor collectives issued


def _note(x: torch.Tensor, group) -> None:
    transports[f"{dist.get_backend(group)}/{x.device.type}"] += 1


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``axis``; returns ``x``."""
    group = mesh.group(axis)
    if group is None:
        return x
    _note(x, group)
    dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce_world_(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over every rank of the mesh."""
    if mesh.device_mesh is None:
        return x
    _note(x, None)
    dist.all_reduce(x, op=op)
    return x


def all_gather_dim0(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ``axis`` ranks' ``x`` concatenated along dim 0 in rank order."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.size(axis)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _note(x, group)
    _all_gather_single(out, x, group=group)
    return out


def reduce_scatter_dim0(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over the ``axis`` ranks of ``x``, cut along dim 0 into one
    block per rank; this rank's block."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.size(axis)
    x = x.contiguous()
    assert x.shape[0] % n == 0, (x.shape, n)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _note(x, group)
    _reduce_scatter_single(out, x, group=group)
    return out


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh (no-op without one, or on one rank)."""
    if mesh is not None and mesh.device_mesh is not None:
        dist.barrier()


def all_gather_objects(obj, mesh: Mesh) -> List:
    """Every rank's picklable ``obj``, in rank order."""
    if mesh.device_mesh is None:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_dim0(x, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim0(g, ctx.mesh, MODEL_AXIS), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SyncGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, DATA_AXIS), None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole table from this rank's row block ``x`` (all-gather over
    ``model``); backward: reduce-scatter."""
    if mesh.size(MODEL_AXIS) == 1:
        return x
    return _AllGatherRows.apply(x, mesh)


def psum(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (all-reduce); backward: identity (every
    rank of the axis consumes the sum alike)."""
    if mesh.size(axis) == 1:
        return x
    return _Psum.apply(x, mesh, axis)


def sync_grads(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` whose gradient is all-reduced over ``data`` (identity with one
    data rank)."""
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return x
    return _SyncGrads.apply(x, mesh)


def all_reduce_grads_(params, mesh: Optional[Mesh]) -> None:
    """Sum the ``.grad`` of each parameter over ``data`` in place (a module
    whose forward ran on a data-parallel slice), in one flat all-reduce; a
    parameter without a gradient takes zeros, so every rank sends the same
    layout."""
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, mesh, DATA_AXIS)
    o = 0
    for p in params:
        p.grad.copy_(flat[o:o + p.numel()].view_as(p))
        o += p.numel()
