"""Synthetic interaction generators (numpy; the same code as the JAX
package's ``data/synthetic.py``, so the same seed gives bit-identical edges
and features).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..constants import EDGE_KEY
from .graph import HeteroGraph


def manual_dummy_graph() -> HeteroGraph:
    """The deterministic 3-customer / 6-article graph of the sampler oracle
    tests: customer 0 buys {0,1,2}, customer 1 buys {2,3,4}, customer 2
    buys {4,5}."""
    edges = np.array(
        [[0, 0], [0, 1], [0, 2], [1, 2], [1, 3], [1, 4], [2, 4], [2, 5]],
        dtype=np.int64,
    )
    users = np.arange(3, dtype=np.int64)
    items = np.arange(6, dtype=np.int64)
    user_features = np.stack([users, users % 2], axis=1).astype(np.int32)
    item_features = np.stack([items, items % 3], axis=1).astype(np.int32)
    return HeteroGraph(
        node_features={EDGE_KEY.src: user_features, EDGE_KEY.dst: item_features},
        edges={EDGE_KEY: (edges[:, 0], edges[:, 1])},
        num_nodes={EDGE_KEY.src: 3, EDGE_KEY.dst: 6},
    )


def random_bipartite_edges(
    seed: int,
    num_users: int,
    num_items: int,
    avg_degree: float,
    popularity_alpha: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random user→item interactions with Zipf-ish item popularity and at
    least one interaction per user; (user, item) pairs are unique.

    ``popularity_alpha`` < 1 flattens the popularity distribution.
    """
    rng = np.random.default_rng(seed)
    # per-user degree ~ 1 + Poisson(avg_degree - 1)
    deg = 1 + rng.poisson(max(avg_degree - 1.0, 0.0), size=num_users)
    deg = np.minimum(deg, num_items)
    total = int(deg.sum())
    users = np.repeat(np.arange(num_users, dtype=np.int64), deg)
    ranks = np.arange(1, num_items + 1, dtype=np.float64)
    probs = ranks ** (-popularity_alpha)
    probs /= probs.sum()
    items = rng.choice(num_items, size=total, p=probs).astype(np.int64)
    # dedup (user, item)
    key = users * num_items + items
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)
    return users[first].astype(np.int64), items[first].astype(np.int64)


def latent_bipartite_edges(
    seed: int,
    num_users: int,
    num_items: int,
    avg_degree: float,
    num_clusters: int = 16,
    in_cluster_p: float = 0.85,
    popularity_alpha: float = 0.8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Clustered (latent-factor) interactions — a *learnable* synthetic
    graph: every user and item carries a hidden cluster id, and each
    interaction draws from the user's own cluster with probability
    ``in_cluster_p`` (popularity-weighted), else from the global popularity
    distribution.

    Returns ``(edge_user, edge_item, user_cluster, item_cluster)``; pairs are
    deduplicated and every user keeps ≥1 interaction.
    """
    rng = np.random.default_rng(seed)
    deg = 1 + rng.poisson(max(avg_degree - 1.0, 0.0), size=num_users)
    deg = np.minimum(deg, num_items)
    total = int(deg.sum())
    users = np.repeat(np.arange(num_users, dtype=np.int64), deg)

    user_cluster = rng.integers(0, num_clusters, num_users)
    item_cluster = rng.integers(0, num_clusters, num_items)
    ranks = np.arange(1, num_items + 1, dtype=np.float64)
    probs = ranks ** (-popularity_alpha)
    probs /= probs.sum()

    items = rng.choice(num_items, size=total, p=probs).astype(np.int64)
    in_cluster = rng.random(total) < in_cluster_p
    ucl = user_cluster[users]
    for c in range(num_clusters):
        sel = in_cluster & (ucl == c)
        n = int(sel.sum())
        if n == 0:
            continue
        members = np.flatnonzero(item_cluster == c)
        if len(members) == 0:  # empty cluster: keep the global draw
            continue
        pc = probs[members] / probs[members].sum()
        items[sel] = members[rng.choice(len(members), size=n, p=pc)]

    key = users * num_items + items
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)
    return (
        users[first].astype(np.int64),
        items[first].astype(np.int64),
        user_cluster.astype(np.int32),
        item_cluster.astype(np.int32),
    )


def random_hetero_graph(
    seed: int,
    num_users: int = 50,
    num_items: int = 80,
    avg_degree: float = 4.0,
    num_user_features: int = 2,
    num_item_features: int = 2,
    feature_cardinality: int = 8,
    num_extra: int = 0,
) -> HeteroGraph:
    """Random hetero graph with categorical features. ``num_extra > 0`` adds
    the colour-group node type with one ``has_color`` edge per item."""
    rng = np.random.default_rng(seed)
    eu, ei = random_bipartite_edges(seed, num_users, num_items, avg_degree)
    uf = rng.integers(0, feature_cardinality, (num_users, num_user_features)).astype(np.int32)
    itf = rng.integers(0, feature_cardinality, (num_items, num_item_features)).astype(np.int32)
    node_features = {EDGE_KEY.src: uf, EDGE_KEY.dst: itf}
    edges = {EDGE_KEY: (eu, ei)}
    num_nodes = {EDGE_KEY.src: num_users, EDGE_KEY.dst: num_items}
    if num_extra > 0:
        from ..constants import EDGE_KEY_EXTRA, NODE_EXTRA

        extra_of_item = rng.integers(0, num_extra, num_items).astype(np.int64)
        node_features[NODE_EXTRA] = np.arange(num_extra, dtype=np.int32)[:, None]
        edges[EDGE_KEY_EXTRA] = (
            np.arange(num_items, dtype=np.int64), extra_of_item
        )
        num_nodes[NODE_EXTRA] = num_extra
    return HeteroGraph(
        node_features=node_features, edges=edges, num_nodes=num_nodes,
    )


def movielens_like_edges(
    seed: int = 0, scale: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """A graph with MovieLens-1M's shape: 6040 users × 3706 items × ~1M
    interactions (scaled by ``scale``). Returns (eu, ei, num_users, num_items)."""
    num_users = max(int(6040 * scale), 8)
    num_items = max(int(3706 * scale), 8)
    avg_degree = 165.6  # 1M / 6040
    eu, ei = random_bipartite_edges(seed, num_users, num_items, avg_degree, 0.8)
    return eu, ei, num_users, num_items
