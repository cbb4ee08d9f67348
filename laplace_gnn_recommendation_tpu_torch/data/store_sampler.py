"""DB-backed subgraph sampling — the port of the JAX package's
``data/store_sampler.py``, counterpart of the reference's
``GraphDatasetNeo`` (``data/dataset_neo.py:48-168``): training examples
whose N-hop neighbourhood comes from a graph STORE (Cypher
``apoc.path.subgraphAll`` round trip per seed) instead of the in-process
CSR BFS, with the multi-edge-type generalization —
``config.default_edge_types`` get the full positive/negative label
treatment, ``config.other_edge_types`` (e.g. ``has_color``) ride along in
the subgraph untouched (``dataset_neo.py:67-93,140-168``).

Two pieces, both host code (the batches they build go to the card like the
in-process sampler's):

* :class:`InMemoryGraphStore` — a store implementing ``run_match`` for the
  Cypher the sampler issues (the reference's backend-parity hook needs a
  live Neo4j server, ``tests/test_dataset.py:26-30``). It executes
  ``subgraphAll`` semantics: nodes within ``maxLevel`` undirected filtered
  hops of the seed, then EVERY filtered relationship among those nodes, with
  the split encoded as relationship-type suffixes exactly like the
  bulk-import format (``graph_store.export_bulk_import_csvs``).
* :class:`GraphStoreSampler` — a :class:`~.sampler.SubgraphSampler` whose
  neighbourhood comes from any object with the ``Database`` interface
  (``graph_store.Database`` against a real server, or the in-memory store).
  The positive/negative/label assembly is SHARED with the in-process
  sampler, so the two backends produce identical batches whenever the
  neighbourhood saturates (the parity contract the reference's integrity
  test pins).

Semantics note (reference fidelity): ``dataset_neo.get_edge_indexes`` unions
the neighborhood with the SAMPLED positive edges only (``:140-168``), but the
``subgraphAll`` neighborhood at ``minLevel=1`` already contains every direct
edge of the seed, so the union equals "all positives + hop edges" — the same
edge set the in-process path assembles.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs import Config
from ..constants import EDGE_KEY, Constants
from ..types import EdgeType
from .graph import HostCSR
from .graph_store import SubgraphRows
from .sampler import SamplerBudgets, SubgraphSampler


class InMemoryGraphStore:
    """A ``Database``-compatible store over host arrays.

    ``edge_split[edge_type]`` assigns each edge a split (0=TRAIN, 1=VAL,
    2=TEST); ``None`` stores the relationship unsuffixed (the extra-edge
    convention — reference ``save.py`` only suffixes ``buys``).
    """

    _SPLIT_NAMES = ("TRAIN", "VAL", "TEST")

    def __init__(
        self,
        node_label_of_type: Dict[str, str],            # node type → label
        edges: Dict[EdgeType, Tuple[np.ndarray, np.ndarray]],
        edge_split: Optional[Dict[EdgeType, Optional[np.ndarray]]] = None,
    ):
        self.node_label_of_type = dict(node_label_of_type)
        self.edges = {k: (np.asarray(s), np.asarray(d)) for k, (s, d) in edges.items()}
        self.edge_split = dict(edge_split or {})
        # one flat relationship table: (rel_name, src_type, dst_type, s, d)
        self._rels: List[Tuple[str, EdgeType, np.ndarray, np.ndarray]] = []
        for et, (s, d) in self.edges.items():
            split = self.edge_split.get(et)
            if split is None:
                self._rels.append((et.rel, et, s, d))
            else:
                split = np.asarray(split)
                for code, name in enumerate(self._SPLIT_NAMES):
                    m = split == code
                    if m.any():
                        self._rels.append(
                            (f"{et.rel}_{name}", et, s[m], d[m])
                        )
        # per-type node-id universe (dense 0..max ids — the bulk-import
        # format's contiguous-id contract) for membership bitmaps
        self._n_of_type: Dict[str, int] = {}
        for _, et, s, d in self._rels:
            if len(s):
                self._n_of_type[et.src] = max(
                    self._n_of_type.get(et.src, 1), int(s.max()) + 1
                )
                self._n_of_type[et.dst] = max(
                    self._n_of_type.get(et.dst, 1), int(d.max()) + 1
                )
        for t in self.node_label_of_type:
            self._n_of_type.setdefault(t, 1)
        # CSR (by src) + CSC (by dst) index per relationship: frontier
        # expansion and the final edge filter run as array ops, O(E) a query
        # (a per-node rescan of the table is O(F·E))
        self._idx: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        for _, et, s, d in self._rels:
            n_s, n_d = self._n_of_type[et.src], self._n_of_type[et.dst]
            o_s = np.argsort(s, kind="stable")
            ptr_s = np.zeros(n_s + 1, np.int64)
            np.cumsum(np.bincount(s, minlength=n_s), out=ptr_s[1:])
            o_d = np.argsort(d, kind="stable")
            ptr_d = np.zeros(n_d + 1, np.int64)
            np.cumsum(np.bincount(d, minlength=n_d), out=ptr_d[1:])
            self._idx.append((ptr_s, d[o_s], ptr_d, s[o_d]))
        self.queries_served = 0

    # -- Database interface -------------------------------------------------

    def close(self) -> None:
        pass

    def run_match(self, query: str):
        m = re.search(
            r"MATCH \(p:(\w+) \{_id: '(\d+)'\}\).*relationshipFilter: '([^']*)'"
            r".*maxLevel: (\d+)",
            query,
        )
        if m is None:
            raise ValueError(f"unsupported query: {query!r}")
        node_type, node_id, rel_filter, max_level = m.groups()
        rows = self._subgraph_all(
            node_type, int(node_id), rel_filter.split("|"), int(max_level)
        )
        self.queries_served += 1
        return [[rows]]

    def get_neighborhood(
        self, node_id: int, n_neighbor: int, start_neighbor: int, split_type: str
    ) -> Dict[EdgeType, np.ndarray]:
        """Same composition as ``graph_store.Database.get_neighborhood``:
        the real query builder and row decode, so the Cypher round trip is
        what runs."""
        from .graph_store import decode_subgraph_rows, query_n_neighbors

        result = self.run_match(
            query_n_neighbors(
                node_id=node_id, n_neighbor=n_neighbor,
                node_type=Constants.node_user, split_type=split_type,
                start_neighbor=start_neighbor, no_return=True,
            )
        )
        return decode_subgraph_rows(result[0][0])

    # -- subgraphAll semantics ----------------------------------------------

    @staticmethod
    def _ragged_gather(ptr: np.ndarray, vals: np.ndarray, ids: np.ndarray):
        """Concatenated ``vals[ptr[i]:ptr[i+1]]`` for every ``i`` in ``ids``
        — the vectorized neighbor expansion (no Python per-node loop)."""
        starts, ends = ptr[ids], ptr[ids + 1]
        counts = ends - starts
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, vals.dtype)
        # standard ragged-gather: absolute positions via repeat + cumsum
        out_idx = np.repeat(starts, counts) + (
            np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        return vals[out_idx]

    def _subgraph_all(
        self, node_type: str, node_id: int, allowed: List[str], max_level: int
    ) -> SubgraphRows:
        """The rows of ``apoc.path.subgraphAll`` from one seed, by
        relationship (:class:`~.graph_store.SubgraphRows`)."""
        allowed_set = set(allowed)
        # frontier BFS with per-type membership bitmaps + CSR/CSC expansion
        in_mask = {t: np.zeros(n, bool) for t, n in self._n_of_type.items()}
        if node_id >= len(in_mask.get(node_type, ())):
            return SubgraphRows([])  # an isolated seed outside every relationship's universe
        in_mask[node_type][node_id] = True
        frontier: Dict[str, np.ndarray] = {
            node_type: np.asarray([node_id], np.int64)
        }
        for _ in range(max_level):
            nxt: Dict[str, List[np.ndarray]] = {}
            for (rel_name, et, _, _), (ptr_s, d_by_s, ptr_d, s_by_d) in zip(
                self._rels, self._idx
            ):
                if rel_name not in allowed_set:
                    continue
                f = frontier.get(et.src)
                if f is not None and len(f):
                    nxt.setdefault(et.dst, []).append(
                        self._ragged_gather(ptr_s, d_by_s, f)
                    )
                f = frontier.get(et.dst)
                if f is not None and len(f):
                    nxt.setdefault(et.src, []).append(
                        self._ragged_gather(ptr_d, s_by_d, f)
                    )
            frontier = {}
            for t, parts in nxt.items():
                cand = np.unique(np.concatenate(parts))
                cand = cand[~in_mask[t][cand]]
                if len(cand):
                    in_mask[t][cand] = True
                    frontier[t] = cand
            if not frontier:
                break
        # every allowed relationship among the subgraph's nodes (one
        # vectorized membership mask per relationship)
        blocks = []
        for rel_name, et, s, d in self._rels:
            if rel_name not in allowed_set or not len(s):
                continue
            m = in_mask[et.src][s] & in_mask[et.dst][d]
            if m.any():
                blocks.append((self.node_label_of_type[et.src], rel_name,
                               self.node_label_of_type[et.dst], s[m], d[m]))
        return SubgraphRows(blocks)


class GraphStoreSampler(SubgraphSampler):
    """Batch sampler whose neighborhoods come from a graph store.

    Same output contract (:class:`~.sampler.SubgraphBatch`) and the same
    positive/negative/label assembly as the in-process sampler; only the
    N-hop edge fetch differs — one ``get_neighborhood`` store round-trip per
    seed (the reference's per-``__getitem__`` Cypher call,
    ``dataset_neo.py:51-57``). ``other_edge_types`` fetched alongside are
    stashed on :attr:`last_other_edges` after every batch (global-id [2, E]
    per type), mirroring the extra HeteroData fields of
    ``dataset_neo.py:85-93``.
    """

    def __init__(
        self,
        cfg: Config,
        store,                      # Database-compatible (run_match/get_neighborhood)
        user_csr: HostCSR,
        item_csr: HostCSR,
        train: bool,
        split_type: str = "train",
        matchers: Optional[Sequence] = None,
        randomization: bool = True,
        seed: int = 0,
        budgets: Optional[SamplerBudgets] = None,
    ):
        super().__init__(
            cfg, user_csr, item_csr, train, matchers=matchers,
            randomization=randomization, seed=seed, budgets=budgets,
            use_native=False,  # the neighborhood comes from the store
        )
        self.store = store
        self.split_type = split_type
        self.last_other_edges: Dict[EdgeType, np.ndarray] = {}

    def _batch_n_hop_edges(self, seed_users: np.ndarray):
        out = []
        other: Dict[EdgeType, List[np.ndarray]] = {}
        for u in seed_users:
            u = int(u)
            nbh = self.store.get_neighborhood(
                u, self.cfg.n_hop_neighbors, 1, self.split_type
            )
            for et in self.cfg.other_edge_types:
                if et in nbh:
                    other.setdefault(et, []).append(nbh[et])
            hop: List[Tuple[np.ndarray, np.ndarray]] = []
            for et in self.cfg.default_edge_types:
                e = nbh.get(et)
                if e is None or e.size == 0:
                    continue
                # the seed's own direct edges are re-added by the shared
                # assembly as positive edges — drop them here (the
                # in-process BFS excludes hop-0 edges the same way)
                keep = e[0] != u
                hop.append((e[0][keep], e[1][keep]))
            if hop:
                out.append(
                    (
                        np.concatenate([h[0] for h in hop]).astype(np.int64),
                        np.concatenate([h[1] for h in hop]).astype(np.int64),
                    )
                )
            else:
                out.append((np.empty(0, np.int64), np.empty(0, np.int64)))
        self.last_other_edges = {
            et: np.concatenate(parts, axis=1) for et, parts in other.items()
        }
        return out

    def clone(self, seed: int) -> "GraphStoreSampler":
        """A worker-owned view for parallel sampling that keeps the store
        (the in-process sampler's ``clone`` would fall back to its BFS)."""
        return GraphStoreSampler(
            self.cfg, self.store, self.users, self.items, self.train,
            split_type=self.split_type, matchers=self.matchers or None,
            randomization=self.randomization, seed=seed, budgets=self.budgets,
        )
