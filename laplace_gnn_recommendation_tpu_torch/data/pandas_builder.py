"""Generic tabular→graph builder — the port's copy of the JAX package's
``data/pandas_builder.py``, counterpart of the reference's
``PandasGraphBuilder`` (``pinsage/builder.py:16-127``), which assembles a DGL
heterograph from entity/relation dataframes. Here the product is the
port's own :class:`~.graph.HeteroGraph` (host arrays) plus the raw-id
maps, so any pandas dataset drops into every pipeline (PinSAGE via
``build_pinsage_data``, encoder-decoder via ``create_link_pred_data``, …).

Usage mirrors the reference's::

    b = PandasGraphBuilder()
    b.add_entities(users_df, "user_id", "customer", feature_cols=["age"])
    b.add_binary_relations(plays_df, "user_id", "game_id", "buys")
    graph, id_maps = b.build()

Categorical feature columns are label-encoded with the shared
``etl.encode_labels``; primary keys map to contiguous ids in first-seen
order (``create_ids_and_maps`` semantics).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..types import EdgeType
from .graph import HeteroGraph


class PandasGraphBuilder:
    def __init__(self):
        self._entities: Dict[str, dict] = {}      # node type → info
        self._relations: List[dict] = []
        self._pk_to_type: Dict[str, str] = {}

    def add_entities(
        self,
        frame,
        primary_key: str,
        node_type: str,
        feature_cols: Optional[List[str]] = None,
        float_feature_cols: Optional[List[str]] = None,
    ) -> "PandasGraphBuilder":
        """Register one node type from a dataframe (one row per entity)."""
        keys = frame[primary_key].to_numpy()
        uniq, first = np.unique(keys, return_index=True)
        if len(uniq) != len(keys):
            raise ValueError(f"duplicate primary keys in {node_type}")
        id_of = {k: i for i, k in enumerate(keys)}
        feats = None
        if feature_cols:
            from .etl import encode_labels

            cols = [encode_labels(frame[c]).astype(np.int32) for c in feature_cols]
            feats = np.stack(cols, axis=1)
        ffeats = None
        if float_feature_cols:
            ffeats = frame[float_feature_cols].to_numpy().astype(np.float32)
        self._entities[node_type] = dict(
            id_of=id_of, n=len(keys), features=feats, float_features=ffeats,
            raw_ids=keys,
        )
        self._pk_to_type[primary_key] = node_type
        return self

    def add_binary_relations(
        self,
        frame,
        src_key: str,
        dst_key: str,
        relation: str,
    ) -> "PandasGraphBuilder":
        """Register one edge type; endpoint node types are resolved from the
        primary-key column names registered by :meth:`add_entities`."""
        src_type = self._pk_to_type[src_key]
        dst_type = self._pk_to_type[dst_key]
        self._relations.append(
            dict(
                frame=frame, src_key=src_key, dst_key=dst_key,
                src_type=src_type, dst_type=dst_type, relation=relation,
            )
        )
        return self

    def build(self) -> Tuple[HeteroGraph, Dict[str, dict]]:
        """(HeteroGraph, raw-id maps per node type)."""
        node_features = {}
        node_features_float = {}
        num_nodes = {}
        id_maps = {}
        for t, info in self._entities.items():
            num_nodes[t] = info["n"]
            id_maps[t] = info["id_of"]
            node_features[t] = (
                info["features"]
                if info["features"] is not None
                # id-only entities still need a feature column downstream
                else np.arange(info["n"], dtype=np.int32)[:, None]
            )
            if info["float_features"] is not None:
                node_features_float[t] = info["float_features"]
        edges = {}
        for r in self._relations:
            s_map = self._entities[r["src_type"]]["id_of"]
            d_map = self._entities[r["dst_type"]]["id_of"]
            f = r["frame"]
            s = np.fromiter(
                (s_map[k] for k in f[r["src_key"]].to_numpy()), np.int64,
                count=len(f),
            )
            d = np.fromiter(
                (d_map[k] for k in f[r["dst_key"]].to_numpy()), np.int64,
                count=len(f),
            )
            edges[EdgeType(r["src_type"], r["relation"], r["dst_type"])] = (s, d)
        return (
            HeteroGraph(
                node_features=node_features,
                edges=edges,
                num_nodes=num_nodes,
                node_features_float=node_features_float,
            ),
            id_maps,
        )
