"""LightGCN data bundle: split graphs + padded eval arrays (counterpart of
the JAX package's ``data/lightgcn_data.py``; the host arrays are identical
for the same inputs, the graphs hold torch tensors on ``device``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..constants import EDGE_KEY
from .graph import BipartiteGraph, HeteroGraph
from .splitting import random_edge_split


def padded_user_items(
    users: np.ndarray,
    edge_user: np.ndarray,
    edge_item: np.ndarray,
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """For each user in ``users``, its items from (edge_user, edge_item), as a
    right-padded int32 [B, G] matrix + count vector [B]. Pad value is -1
    (never a valid item id). Vectorized: one scatter instead of a per-user
    loop, the same output."""
    order = np.argsort(edge_user, kind="stable")
    eu, ei = edge_user[order], edge_item[order]
    starts = np.searchsorted(eu, users, side="left")
    ends = np.searchsorted(eu, users, side="right")
    counts = (ends - starts).astype(np.int32)
    g = int(pad_to if pad_to is not None else max(int(counts.max(initial=0)), 1))
    out = np.full((len(users), g), -1, dtype=np.int32)
    kept = np.minimum(counts, g).astype(np.int64)
    total = int(kept.sum())
    if total:
        rows = np.repeat(np.arange(len(users)), kept)
        offs = np.arange(total) - np.repeat(np.cumsum(kept) - kept, kept)
        out[rows, offs] = ei[np.repeat(starts, kept) + offs]
    return out, counts


@dataclass
class EvalSet:
    """Eval bundle for one split (host arrays)."""

    users: np.ndarray          # int32 [B] unique users in the split
    gt_items: np.ndarray       # int32 [B, G] padded ground truth
    gt_count: np.ndarray       # int32 [B]
    exclude_items: np.ndarray  # int32 [B, X] padded exclusion (train/+val edges)
    exclude_count: np.ndarray  # int32 [B]
    edge_user: np.ndarray      # int32 [E] raw eval edges (for the loss term)
    edge_item: np.ndarray


def build_eval_set(
    eval_edges: Tuple[np.ndarray, np.ndarray],
    exclude_edge_lists: List[Tuple[np.ndarray, np.ndarray]],
) -> EvalSet:
    """Assemble the padded arrays for one eval split; ``exclude_edge_lists``
    is [train] for val and [train, val] for test."""
    eu, ei = eval_edges
    users = np.unique(eu).astype(np.int32)
    gt_items, gt_count = padded_user_items(users, eu, ei)
    if exclude_edge_lists:
        xu = np.concatenate([e[0] for e in exclude_edge_lists])
        xi = np.concatenate([e[1] for e in exclude_edge_lists])
        exclude_items, exclude_count = padded_user_items(users, xu, xi)
    else:
        exclude_items = np.full((len(users), 1), -1, np.int32)
        exclude_count = np.zeros(len(users), np.int32)
    return EvalSet(
        users=users,
        gt_items=gt_items,
        gt_count=gt_count.astype(np.int32),
        exclude_items=exclude_items,
        exclude_count=exclude_count.astype(np.int32),
        edge_user=eu.astype(np.int32),
        edge_item=ei.astype(np.int32),
    )


@dataclass
class LightGCNData:
    num_users: int
    num_items: int
    train_graph: BipartiteGraph
    val_graph: BipartiteGraph
    test_graph: BipartiteGraph
    train_edges: Tuple[np.ndarray, np.ndarray]
    val_edges: Tuple[np.ndarray, np.ndarray]
    test_edges: Tuple[np.ndarray, np.ndarray]
    all_edges: Tuple[np.ndarray, np.ndarray]
    val_set: EvalSet = None
    test_set: EvalSet = None


def create_lightgcn_data(
    edge_user: np.ndarray,
    edge_item: np.ndarray,
    num_users: int,
    num_items: int,
    split_seed: int = 1,
    pad_multiple: int = 128,
    device="cuda",
) -> LightGCNData:
    """Seeded 80/10/10 split + one graph per split on ``device`` + the
    padded eval sets."""
    edge_user = np.asarray(edge_user, np.int32)
    edge_item = np.asarray(edge_item, np.int32)
    tr, va, te = random_edge_split(len(edge_user), seed=split_seed)

    def graph(idx):
        return BipartiteGraph.from_edges(
            edge_user[idx], edge_item[idx], num_users, num_items,
            pad_multiple=pad_multiple, device=device,
        )

    train_edges = (edge_user[tr], edge_item[tr])
    val_edges = (edge_user[va], edge_item[va])
    test_edges = (edge_user[te], edge_item[te])
    data = LightGCNData(
        num_users=num_users,
        num_items=num_items,
        train_graph=graph(tr),
        val_graph=graph(va),
        test_graph=graph(te),
        train_edges=train_edges,
        val_edges=val_edges,
        test_edges=test_edges,
        all_edges=(edge_user, edge_item),
    )
    data.val_set = build_eval_set(val_edges, [train_edges])
    data.test_set = build_eval_set(test_edges, [train_edges, val_edges])
    return data


def lightgcn_data_from_hetero(g: HeteroGraph, **kw) -> LightGCNData:
    """Build from the preprocessed hetero graph's ``buys`` edge set (the
    reference loads ``test_graph.pt`` and flattens it to homogeneous,
    ``data/lightgcn_loader.py:55-61``); ``kw`` go to
    :func:`create_lightgcn_data` (``device=`` among them)."""
    s, d = g.edges[EDGE_KEY]
    return create_lightgcn_data(
        s, d, g.num_nodes[EDGE_KEY.src], g.num_nodes[EDGE_KEY.dst], **kw
    )
