"""Optional out-of-process graph store (Neo4j) — the port's copy of the JAX
package's ``data/graph_store.py``, counterpart of reference ``data/neo4j/``
(``neo4j_database.py:8-87``, ``save.py:15-126``, ``utils.py:8-40``): Cypher
query builders, a Bolt driver wrapper (the ``neo4j`` driver is imported when
a :class:`Database` is made), bulk-import CSV export in ``neo4j-admin``
format with the split encoded as relationship type suffixes
``_TRAIN/_VAL/_TEST``, and the subgraph-fetch decode the store-backed
sampler uses.

The query builders and the CSV export are pure functions, tested without a
server; their strings and files are the JAX package's byte for byte. The
in-process native sampler stays the production path (the reference's
Cypher round trip per seed is its sampling bottleneck, SURVEY §2c).
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..constants import Constants
from ..types import EdgeType

PERIODIC_COMMIT = "USING PERIODIC COMMIT 10000 "


# ---- Cypher builders (reference neo4j_database.py:17-63) -----------------

def query_node(node_id: int, node_type: str, no_return: bool = False) -> str:
    q = f"MATCH(n:{node_type} {{_id:'{node_id}'}})"
    return q + (" " if no_return else " RETURN n")


def split_relationship_filter(split_type: str) -> str:
    """Progressive relationship filter: train ⊂ +val ⊂ +test — reference
    ``neo4j_database.py:34-44``."""
    base = f"{Constants.rel_type}_TRAIN"
    if split_type == "val":
        base += f"|{Constants.rel_type}_VAL"
    elif split_type == "test":
        base += f"|{Constants.rel_type}_VAL|{Constants.rel_type}_TEST"
    return base + f"|{Constants.rel_type_extra}"


def query_n_neighbors(
    node_id: int,
    n_neighbor: int,
    node_type: str,
    split_type: str,
    start_neighbor: int = 0,
    no_return: bool = False,
) -> str:
    """apoc.path.subgraphAll n-hop query — reference ``neo4j_database.py:26-57``.

    The query body already RETURNs the decoded relationship array; the
    reference's ``no_return=False`` branch appends a *second* RETURN clause
    (invalid Cypher — its only exercised call site passes no_return=True).
    Here ``no_return`` only controls the trailing space, and the query is
    valid either way.
    """
    rel = split_relationship_filter(split_type)
    q = (
        f"MATCH (p:{node_type} {{_id: '{node_id}'}}) "
        f" CALL apoc.path.subgraphAll(p, {{relationshipFilter: '{rel}', "
        f"minLevel: {start_neighbor}, maxLevel: {n_neighbor}}})"
        " YIELD relationships"
        " RETURN [r in relationships | [LABELS(STARTNODE(r))[0],TYPE(r),"
        "LABELS(ENDNODE(r))[0], STARTNODE(r)._id,ENDNODE(r)._id]] as arraysomething"
    )
    return q + (" " if no_return else "")


def query_all_nodes(node_type: str) -> str:
    return f"MATCH (n:{node_type}) RETURN n"


def _strip_split(rel_type: str) -> str:
    return rel_type.replace("_TRAIN", "").replace("_TEST", "").replace("_VAL", "")


class SubgraphRows:
    """A subgraphAll answer held by relationship: ``blocks`` of
    ``(src_label, rel_type, dst_label, src_ids, dst_ids)`` with one id array
    pair each. Iterating yields the rows a server returns, ``[src_label,
    rel_type, dst_label, src_id, dst_id]``, in the same order;
    :func:`decode_subgraph_rows` reads the arrays whole instead (a Python
    list per row costs microseconds, and a 2-hop neighbourhood holds tens of
    thousands of rows)."""

    def __init__(self, blocks: List[tuple]):
        self.blocks = blocks

    def __iter__(self):
        for src_label, rel, dst_label, a, b in self.blocks:
            for x, y in zip(a.tolist(), b.tolist()):
                yield [src_label, rel, dst_label, x, y]

    def __len__(self) -> int:
        return sum(len(blk[3]) for blk in self.blocks)


def decode_subgraph_rows(rows) -> Dict[EdgeType, np.ndarray]:
    """Decode the subgraphAll result into per-edge-type [2, E] arrays —
    reference ``data/neo4j/utils.py:20-40`` (split suffixes stripped). Rows
    from a server are decoded one by one; a :class:`SubgraphRows` gives the
    same arrays from its blocks."""
    blocks = getattr(rows, "blocks", None)
    if blocks is not None:
        parts: Dict[EdgeType, list] = defaultdict(list)
        for src_label, rel, dst_label, a, b in blocks:
            parts[EdgeType(src_label, _strip_split(rel), dst_label)].append(
                np.stack([np.asarray(a, np.int64), np.asarray(b, np.int64)]))
        return {k: np.concatenate(v, axis=1) for k, v in parts.items()}
    edge_index: Dict[EdgeType, list] = defaultdict(list)
    for from_type, rel_type, to_type, from_id, to_id in rows:
        edge_index[EdgeType(from_type, _strip_split(rel_type), to_type)].append(
            (int(from_id), int(to_id))
        )
    return {
        k: np.array(v, dtype=np.int64).T if v else np.empty((2, 0), np.int64)
        for k, v in edge_index.items()
    }


# ---- driver wrapper (gated) ----------------------------------------------

class Database:
    """Bolt driver wrapper — reference ``neo4j_database.py:8-87``. Requires
    the ``neo4j`` package; constructing without it raises with a clear
    message."""

    def __init__(self, uri: str, user: str, password: str):
        try:
            from neo4j import GraphDatabase  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "neo4j driver not installed; the in-process sampler "
                "(data.sampler.SubgraphSampler) is the supported path here"
            ) from e
        self.driver = GraphDatabase.driver(uri, auth=(user, password))

    def close(self):  # pragma: no cover - needs server
        self.driver.close()

    def run_match(self, query: str):  # pragma: no cover - needs server
        with self.driver.session() as session:
            return list(session.run(query))

    def clear(self):  # pragma: no cover - needs server
        self.run_match("MATCH (n) DETACH DELETE n")

    def create_indexes(self):  # pragma: no cover - needs server
        self.run_match("CREATE INDEX ON :Customer(_id)")
        self.run_match("CREATE INDEX ON :Article(_id)")

    def get_neighborhood(
        self, node_id: int, n_neighbor: int, start_neighbor: int, split_type: str
    ) -> Dict[EdgeType, np.ndarray]:  # pragma: no cover - needs server
        result = self.run_match(
            query_n_neighbors(
                node_id=node_id, n_neighbor=n_neighbor,
                node_type=Constants.node_user, split_type=split_type,
                start_neighbor=start_neighbor, no_return=True,
            )
        )
        return decode_subgraph_rows(result[0][0])


# ---- bulk import export (reference save.py:15-126) -----------------------

def export_bulk_import_csvs(
    out_dir: str,
    customer_features: np.ndarray,        # int [U, F]
    customer_feature_names: List[str],
    article_features: np.ndarray,         # int [I, F]
    article_feature_names: List[str],
    edge_user: np.ndarray,
    edge_item: np.ndarray,
    train_mask: np.ndarray,
    val_mask: np.ndarray,
    test_mask: np.ndarray,
) -> List[str]:
    """Write neo4j-admin bulk-import CSVs; the split lives in the
    relationship type suffix (``buys_TRAIN``/``_VAL``/``_TEST``), exactly the
    reference's encoding (``save.py:69-99``). Returns written paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []

    def write(name: str, header: List[str], rows) -> str:
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(",".join(header) + "\n")
            for row in rows:
                f.write(",".join(str(x) for x in row) + "\n")
        paths.append(path)
        return path

    u_hdr = [f":ID({Constants.node_user})"] + customer_feature_names + [":LABEL", "_id"]
    write(
        "customers.csv", u_hdr,
        (
            [i, *customer_features[i], Constants.node_user, i]
            for i in range(len(customer_features))
        ),
    )
    a_hdr = [f":ID({Constants.node_item})"] + article_feature_names + [":LABEL", "_id"]
    write(
        "articles.csv", a_hdr,
        (
            [i, *article_features[i], Constants.node_item, i]
            for i in range(len(article_features))
        ),
    )

    def rel_type(j: int) -> str:
        if train_mask[j]:
            return f"{Constants.rel_type}_TRAIN"
        if val_mask[j]:
            return f"{Constants.rel_type}_VAL"
        return f"{Constants.rel_type}_TEST"

    t_hdr = [
        f":START_ID({Constants.node_user})",
        f":END_ID({Constants.node_item})",
        ":TYPE",
    ]
    write(
        "transactions.csv", t_hdr,
        ([int(edge_user[j]), int(edge_item[j]), rel_type(j)] for j in range(len(edge_user))),
    )
    return paths


def bulk_import_command(out_dir: str, database: str = "neo4j") -> str:
    """The neo4j-admin invocation for the exported CSVs — reference
    ``save.py:90-99`` (shell-out left to the caller)."""
    return (
        f"neo4j-admin import --database={database} --force "
        f"--nodes={out_dir}/customers.csv --nodes={out_dir}/articles.csv "
        f"--relationships={out_dir}/transactions.csv"
    )
