"""Shared ETL primitives: label encoding, contiguous id maps, node filtering,
artifact IO — the port's copy of the JAX package's ``data/etl.py``
(reference ``utils/labelencoder.py:4-6``, ``utils/preprocessing.py:73-89``
and the artifact-saving tails of ``run_preprocessing*.py``).

Artifacts are npz/json (no pickles): one hetero graph with chronologically
sorted edges, the split masks and the id maps. The files and keys are the
JAX package's, so an artifact directory written by either package loads in
the other.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from .graph import HeteroGraph, load_hetero_graph, save_hetero_graph


def encode_labels(values: np.ndarray) -> np.ndarray:
    """Label-encode by sorted unique value — pandas
    ``astype('category').cat.codes`` on clean data (reference
    ``utils/labelencoder.py:4-6``)."""
    values = np.asarray(values)
    _, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int64)


def create_ids_and_maps(
    raw_ids: np.ndarray, start: int = 0
) -> Tuple[Dict[int, object], Dict[object, int]]:
    """Contiguous ids in the current row order (reference
    ``utils/preprocessing.py:73-81``): (forward new→raw, reverse raw→new)."""
    forward = {start + i: raw for i, raw in enumerate(raw_ids)}
    reverse = {raw: k for k, raw in forward.items()}
    return forward, reverse


def filter_unconnected(node_raw_ids: np.ndarray, referenced: np.ndarray) -> np.ndarray:
    """Boolean keep-mask dropping nodes no transaction references (reference
    ``run_preprocessing.py:76-90``)."""
    ref = set(np.asarray(referenced).tolist())
    return np.array([rid in ref for rid in node_raw_ids], dtype=bool)


@dataclass
class LinkPredArtifacts:
    """Everything the training pipelines load."""

    graph: HeteroGraph            # edges chronologically sorted
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    customer_id_map_forward: Dict[str, object]
    article_id_map_forward: Dict[str, object]
    popular_items: Optional[np.ndarray] = None
    location_for_user: Optional[np.ndarray] = None
    users_per_location: Optional[Dict[int, list]] = None


def save_artifacts(artifact_dir: str, a: LinkPredArtifacts) -> None:
    os.makedirs(artifact_dir, exist_ok=True)
    save_hetero_graph(os.path.join(artifact_dir, "graph.npz"), a.graph)
    np.savez_compressed(
        os.path.join(artifact_dir, "split_masks.npz"),
        train=a.train_mask, val=a.val_mask, test=a.test_mask,
    )
    for name, m in (("customer_id_map_forward", a.customer_id_map_forward),
                    ("article_id_map_forward", a.article_id_map_forward)):
        with open(os.path.join(artifact_dir, f"{name}.json"), "w") as f:
            json.dump({str(k): str(v) for k, v in m.items()}, f)
    if a.popular_items is not None:
        np.savez_compressed(os.path.join(artifact_dir, "most_popular_products.npz"),
                            items=a.popular_items)
    if a.location_for_user is not None:
        np.savez_compressed(os.path.join(artifact_dir, "locations.npz"),
                            location_for_user=a.location_for_user)


def load_artifacts(artifact_dir: str) -> LinkPredArtifacts:
    graph = load_hetero_graph(os.path.join(artifact_dir, "graph.npz"))
    with np.load(os.path.join(artifact_dir, "split_masks.npz")) as masks:
        train, val, test = masks["train"], masks["val"], masks["test"]
    with open(os.path.join(artifact_dir, "customer_id_map_forward.json")) as f:
        cmap = json.load(f)
    with open(os.path.join(artifact_dir, "article_id_map_forward.json")) as f:
        amap = json.load(f)
    popular = None
    pop_path = os.path.join(artifact_dir, "most_popular_products.npz")
    if os.path.exists(pop_path):
        with np.load(pop_path) as z:
            popular = z["items"]
    loc = None
    loc_path = os.path.join(artifact_dir, "locations.npz")
    if os.path.exists(loc_path):
        with np.load(loc_path) as z:
            loc = z["location_for_user"]
    users_per_location = None
    if loc is not None:
        users_per_location = {}
        for u, l in enumerate(loc):
            users_per_location.setdefault(int(l), []).append(u)
    return LinkPredArtifacts(
        graph=graph,
        train_mask=train, val_mask=val, test_mask=test,
        customer_id_map_forward=cmap,
        article_id_map_forward=amap,
        popular_items=popular,
        location_for_user=loc,
        users_per_location=users_per_location,
    )
