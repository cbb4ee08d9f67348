"""Plain sparse-adjacency × dense-embedding products (counterpart of the JAX
package's ``ops/spmm.py``): the ``propagation="plain"`` tier and the
numerical reference for the segment-sum kernel.

Each direction is a segment-sum over one sort order of the padded COO edge
list, written as ``index_add_``:

    new_user[u] = Σ_{e : user(e)=u}  w_e · item[item(e)]
    new_item[i] = Σ_{e : item(e)=i}  w_e · user[user(e)]

Pad slots carry w = 0, so they add nothing. On the card ``index_add_``
accumulates with float atomics, so its low bits may change from run to run;
the segment-sum kernel (``ops/spmm_pallas.py``) is the deterministic tier.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..data.graph import BipartiteGraph
from .multiscale import multiscale_loop


def propagate_bipartite(
    g: BipartiteGraph, user_emb: torch.Tensor, item_emb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One symmetric-normalized diffusion step Ã·E; returns
    (new_user_emb, new_item_emb)."""
    msgs_u = g.edge_w[:, None] * item_emb[g.edge_item.long()]
    new_user = torch.zeros(
        (g.num_users, item_emb.shape[1]), dtype=msgs_u.dtype, device=msgs_u.device
    ).index_add_(0, g.edge_user.long(), msgs_u)
    msgs_i = g.edge_w_im[:, None] * user_emb[g.edge_user_im.long()]
    new_item = torch.zeros(
        (g.num_items, user_emb.shape[1]), dtype=msgs_i.dtype, device=msgs_i.device
    ).index_add_(0, g.edge_item_im.long(), msgs_i)
    return new_user, new_item


def lightgcn_propagate(
    g: BipartiteGraph,
    user_emb0: torch.Tensor,
    item_emb0: torch.Tensor,
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-iteration LightGCN diffusion with the multi-scale mean
    E_final = mean(E⁰, …, E^K), E^{k+1} = Ã E^k."""
    return multiscale_loop(
        propagate_bipartite, g, user_emb0, item_emb0, num_iterations
    )
