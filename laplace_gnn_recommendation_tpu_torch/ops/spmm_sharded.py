"""Row-sharded segment-sum SpMM over the mesh's ``model`` axis — the port of
the JAX package's ``ops/spmm_sharded.py`` (the multi-chip propagation path
for graphs too large for one device).

Partitioning, as in the JAX package:

* output rows (users for the item→user direction, items for the reverse)
  are sharded over ``model``: each rank owns a contiguous row block and the
  edges whose destination falls in it (the graph build sorts edges by
  destination, so the partitions are contiguous slices);
* the source table is all-gathered over ``model`` once per direction and
  hop, then each rank sums its own edges into its own rows.

That local sum, Σ w·table[src] into the shard's rows, is what kernel A
computes: it runs on a per-shard ``PallasSegmentPlan`` (f32) — on the card
the kernel, on the CPU its plain version. A row's edges and their order are
the ones of the unsharded plan, so a sharded row equals the unsharded one.
``index_add_`` is not used: its float atomics would break that equality.

Backward of one hop: kernel A on the shard's transposed plans (destination
= the whole source table's rows, source = the shard's own rows; built once
beside the forward plans), then the reduce-scatter that is the all-gather's
backward (``parallel/collectives.all_gather_rows``). The K-loop stays a
plain loop under autograd (JAX ``:168-188``): the whole-loop self-adjoint
Function of the single-device tier does not apply across shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.graph import BipartiteGraph
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import MODEL_AXIS, Mesh
from .multiscale import dense_cotangent, multiscale_loop
from .spmm_pallas import L2_WINDOW_SHARE, PallasSegmentPlan, pallas_segment_sum

EDGE_PAD = 128   # per-shard edge arrays pad to a multiple of this (JAX ``:83``)


def partition_edges(dst: np.ndarray, src: np.ndarray, w: np.ndarray, rows_per_shard: int,
                    parts: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edges sorted by destination, split into ``parts`` equal-length blocks
    ([parts, E_shard] each; JAX ``:76-97``): local destination rows, global
    sources, weights; pads of weight 0 up to a multiple of ``EDGE_PAD``, whose
    destination repeats the block's last real one (non-decreasing)."""
    shard_of = dst // rows_per_shard
    counts = np.bincount(shard_of, minlength=parts)
    e_shard = max(int(counts.max(initial=1)), 1)
    e_shard = -(-e_shard // EDGE_PAD) * EDGE_PAD
    out_dst = np.zeros((parts, e_shard), np.int32)
    out_src = np.zeros((parts, e_shard), np.int32)
    out_w = np.zeros((parts, e_shard), np.float32)
    start = 0
    for p in range(parts):
        n = int(counts[p])
        sl = slice(start, start + n)
        out_dst[p, :n] = dst[sl] - p * rows_per_shard
        out_src[p, :n] = src[sl]
        out_w[p, :n] = w[sl]
        if n > 0:
            out_dst[p, n:] = out_dst[p, n - 1]
        start += n
    return out_dst, out_src, out_w


@dataclass
class ShardedBipartiteGraph:
    """This rank's edge partitions of both directions as kernel A plans (row
    ``p`` of ``partitions``, the JAX layout, without its pads).

    ``to_user`` sums item rows into this rank's user rows, ``to_item`` user
    rows into its item rows; ``*_t`` are their transposes, for the
    backward."""

    to_user: PallasSegmentPlan
    to_item: PallasSegmentPlan
    to_user_t: PallasSegmentPlan
    to_item_t: PallasSegmentPlan
    num_users: int = 0
    num_items: int = 0
    parts: int = 1
    mesh: Optional[Mesh] = None

    @property
    def users_per_shard(self) -> int:
        return self.num_users // self.parts

    @property
    def items_per_shard(self) -> int:
        return self.num_items // self.parts

    @staticmethod
    def partitions(g: BipartiteGraph, parts: int):
        """The JAX package's per-shard arrays of ``g`` for ``parts`` shards:
        ((user dst, item src, w), (item dst, user src, w)), each [parts, E]."""
        assert g.num_users % parts == 0 and g.num_items % parts == 0, (
            "pad node counts to a multiple of the model axis "
            f"({g.num_users}, {g.num_items}) % {parts}"
        )
        eu, ei, w, eu_im, ei_im, w_im = g.host_arrays()
        return (partition_edges(eu, ei, w, g.num_users // parts, parts),
                partition_edges(ei_im, eu_im, w_im, g.num_items // parts, parts))

    @staticmethod
    def from_graph(g: BipartiteGraph, mesh: Mesh, width: int = 0) -> "ShardedBipartiteGraph":
        """This rank's partitions of ``g`` on the mesh's device. Source
        windows follow ``PallasGraph.from_graph`` (f32 rows of ``width``, the
        card's L2; one window on the CPU)."""
        parts = mesh.shape[MODEL_AXIS]
        p = mesh.rank(MODEL_AXIS)
        (ud, us, uw), (idd, ius, iw) = ShardedBipartiteGraph.partitions(g, parts)
        eu, ei, w, eu_im, ei_im, w_im = g.host_arrays()
        dev = mesh.device
        l2_bytes = (torch.cuda.get_device_properties(dev).L2_cache_size
                    if dev.type == "cuda" else 0)
        window_rows = int(L2_WINDOW_SHARE * l2_bytes) // (4 * width) if width else 0
        ups, ips = g.num_users // parts, g.num_items // parts

        def plan(dst, src, weight, rows, num_src):
            return PallasSegmentPlan.from_edges(dst, src, weight, rows, device=dev,
                                                num_src_rows=num_src, window_rows=window_rows)

        # forward: the shard's real edges (the pads weigh 0); transposed: the
        # shard's edges in the other direction's order (sorted by the global
        # source row, then by the local row), local rows as the sources
        n_u = int(np.count_nonzero(eu // ups == p))
        n_i = int(np.count_nonzero(ei_im // ips == p))
        to_user = plan(ud[p, :n_u], us[p, :n_u], uw[p, :n_u], ups, g.num_items)
        to_item = plan(idd[p, :n_i], ius[p, :n_i], iw[p, :n_i], ips, g.num_users)
        t_u, t_i = eu_im // ups == p, ei // ips == p
        to_user_t = plan(ei_im[t_u], eu_im[t_u] - p * ups, w_im[t_u], g.num_items, ups)
        to_item_t = plan(eu[t_i], ei[t_i] - p * ips, w[t_i], g.num_users, ips)

        return ShardedBipartiteGraph(
            to_user=to_user, to_item=to_item, to_user_t=to_user_t, to_item_t=to_item_t,
            num_users=g.num_users, num_items=g.num_items, parts=parts, mesh=mesh,
        )


class _ShardSum(torch.autograd.Function):
    """Kernel A on a shard's plan; backward: kernel A on its transpose."""

    @staticmethod
    def forward(ctx, plan, plan_t, table):
        ctx.plan_t = plan_t
        return pallas_segment_sum(plan, table)

    @staticmethod
    def backward(ctx, g):
        return None, None, pallas_segment_sum(ctx.plan_t, dense_cotangent(g))


def propagate_sharded(
    mesh: Mesh,
    sg: ShardedBipartiteGraph,
    user_emb: torch.Tensor,  # [U/p, D] this rank's row block
    item_emb: torch.Tensor,  # [I/p, D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One diffusion step; outputs are this rank's row blocks, like the
    inputs. Differentiable: kernel A on the transposed plans, then the
    reduce-scatter over ``model``."""
    item_full = all_gather_rows(item_emb, mesh)
    new_u = _ShardSum.apply(sg.to_user, sg.to_user_t, item_full)
    user_full = all_gather_rows(user_emb, mesh)
    new_i = _ShardSum.apply(sg.to_item, sg.to_item_t, user_full)
    return new_u, new_i


def lightgcn_propagate_sharded(
    mesh: Mesh,
    sg: ShardedBipartiteGraph,
    user_emb0: torch.Tensor,
    item_emb0: torch.Tensor,
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-iteration multi-scale mean on the sharded path (the contract of
    ``spmm.lightgcn_propagate``, on row blocks): 2·K launches of kernel A
    forward and 2·K backward on each rank."""
    return multiscale_loop(lambda op, u, i: propagate_sharded(mesh, op, u, i), sg,
                           user_emb0, item_emb0, num_iterations)
