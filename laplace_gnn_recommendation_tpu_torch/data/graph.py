"""Graph containers (counterpart of the JAX package's ``data/graph.py``).

* :class:`BipartiteGraph` — the user↔item interaction graph as a padded COO
  edge list kept in two sort orders (user-major and item-major), as torch
  tensors on an explicit device. Symmetric ``gcn_norm`` weights are
  precomputed at build time.
* :class:`HostCSR` — host-side (numpy) CSR adjacency; never on the device.
* :class:`HeteroGraph` — the typed multi-relation graph of the ranking
  stack (numpy on the host), with ``save_hetero_graph`` /
  ``load_hetero_graph`` (one npz, the JAX package's format).

Pad discipline (kept from the JAX package): padded edge slots carry
``weight == 0`` and repeat the LAST real ids, so each sort order stays
non-decreasing and every segment-sum treats them as no-ops.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..types import EdgeType


def _round_up(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


@dataclass
class BipartiteGraph:
    """Padded COO bipartite interaction graph.

    ``edge_user`` / ``edge_item`` / ``edge_w``: int32/int32/float32 [E_pad],
    sorted by (user, item). ``edge_user_im`` / ``edge_item_im`` /
    ``edge_w_im``: the same edges sorted by (item, user). Weights are
    1/sqrt(deg_u·deg_i), exactly 0 on pad slots. ``user_deg`` /
    ``item_deg``: int32 true degrees.
    """

    edge_user: torch.Tensor
    edge_item: torch.Tensor
    edge_w: torch.Tensor
    edge_user_im: torch.Tensor
    edge_item_im: torch.Tensor
    edge_w_im: torch.Tensor
    user_deg: torch.Tensor
    item_deg: torch.Tensor
    num_users: int = 0
    num_items: int = 0
    num_edges: int = 0

    @property
    def num_edges_padded(self) -> int:
        return int(self.edge_user.shape[0])

    @property
    def device(self) -> torch.device:
        return self.edge_user.device

    @staticmethod
    def from_edges(
        user_idx: np.ndarray,
        item_idx: np.ndarray,
        num_users: int,
        num_items: int,
        pad_multiple: int = 128,
        device="cuda",
    ) -> "BipartiteGraph":
        """Build from raw (user, item) interaction arrays: sorting, degrees
        and normalization in numpy, then one upload to ``device``."""
        dev = resolve_device(device)
        user_idx = np.asarray(user_idx, dtype=np.int32)
        item_idx = np.asarray(item_idx, dtype=np.int32)
        if user_idx.shape != item_idx.shape:
            raise ValueError(f"edge arrays differ: {user_idx.shape} vs {item_idx.shape}")
        e = int(user_idx.shape[0])
        e_pad = _round_up(e, pad_multiple)

        user_deg = np.bincount(user_idx, minlength=num_users).astype(np.int32)
        item_deg = np.bincount(item_idx, minlength=num_items).astype(np.int32)
        du = user_deg[user_idx].astype(np.float64)
        di = item_deg[item_idx].astype(np.float64)
        w = np.where((du > 0) & (di > 0), 1.0 / np.sqrt(np.maximum(du * di, 1.0)), 0.0)

        def _pack(order: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
            uu = np.zeros(e_pad, np.int32)
            ii = np.zeros(e_pad, np.int32)
            ww = np.zeros(e_pad, np.float32)
            uu[:e] = user_idx[order]
            ii[:e] = item_idx[order]
            ww[:e] = w[order]
            if e > 0:
                # pads repeat the last real ids (sorted order kept), w = 0
                uu[e:] = uu[e - 1]
                ii[e:] = ii[e - 1]
            return uu, ii, ww

        uu, ii, ww = _pack(np.lexsort((item_idx, user_idx)))
        uu2, ii2, ww2 = _pack(np.lexsort((user_idx, item_idx)))

        def t(a):
            return torch.from_numpy(a).to(dev)

        g = BipartiteGraph(
            edge_user=t(uu), edge_item=t(ii), edge_w=t(ww),
            edge_user_im=t(uu2), edge_item_im=t(ii2), edge_w_im=t(ww2),
            user_deg=t(user_deg), item_deg=t(item_deg),
            num_users=int(num_users), num_items=int(num_items), num_edges=e,
        )
        # host copies of the six edge arrays, so plan builders (PallasGraph)
        # never download them from the card
        g._host = (uu, ii, ww, uu2, ii2, ww2)
        return g

    def host_arrays(self):
        """(edge_user, edge_item, edge_w, edge_user_im, edge_item_im,
        edge_w_im) as numpy, UNPADDED — from the build-time cache when
        available, else one device→host copy."""
        cached = getattr(self, "_host", None)
        e = self.num_edges
        if cached is not None:
            return tuple(a[:e] for a in cached)
        return tuple(
            x[:e].cpu().numpy()
            for x in (self.edge_user, self.edge_item, self.edge_w,
                      self.edge_user_im, self.edge_item_im, self.edge_w_im)
        )

    def edges_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """The true (unpadded) edge arrays on host, user-major order."""
        eu, ei, *_ = self.host_arrays()
        return eu, ei


class HostCSR:
    """Host-side CSR adjacency (numpy only). ``row_ptr[u]:row_ptr[u+1]``
    slices ``cols`` to the sorted neighbors of ``u``."""

    def __init__(self, row_ptr: np.ndarray, cols: np.ndarray, num_rows: int, num_cols: int):
        self.row_ptr = row_ptr
        self.cols = cols
        self.num_rows = num_rows
        self.num_cols = num_cols

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, num_rows: int, num_cols: int) -> "HostCSR":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        order = np.lexsort((dst, src))
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=num_rows)
        row_ptr = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return HostCSR(row_ptr, dst_s.astype(np.int32), num_rows, num_cols)

    def neighbors(self, row: int) -> np.ndarray:
        return self.cols[self.row_ptr[row] : self.row_ptr[row + 1]]

    def degree(self, row: int) -> int:
        return int(self.row_ptr[row + 1] - self.row_ptr[row])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)


@dataclass
class HeteroGraph:
    """Typed multi-relation graph: features per node type + a bipartite edge
    set per edge type (JAX ``data/graph.py:205-235``).

    ``node_features[t]`` is an int32 [N_t, F_t] categorical feature matrix;
    non-categorical features (e.g. CLIP embeddings) go in
    ``node_features_float[t]`` as float32 [N_t, D_t]. All numpy, on the host.
    """

    node_features: Dict[str, np.ndarray]
    edges: Dict[EdgeType, Tuple[np.ndarray, np.ndarray]]  # (src_idx, dst_idx)
    num_nodes: Dict[str, int]
    node_features_float: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def csr(self, edge_type: EdgeType) -> HostCSR:
        s, d = self.edges[edge_type]
        return HostCSR.from_edges(s, d, self.num_nodes[edge_type.src], self.num_nodes[edge_type.dst])

    def csr_reverse(self, edge_type: EdgeType) -> HostCSR:
        s, d = self.edges[edge_type]
        return HostCSR.from_edges(d, s, self.num_nodes[edge_type.dst], self.num_nodes[edge_type.src])

    def bipartite(self, edge_type: EdgeType, pad_multiple: int = 128,
                  device="cuda") -> BipartiteGraph:
        s, d = self.edges[edge_type]
        return BipartiteGraph.from_edges(
            s, d, self.num_nodes[edge_type.src], self.num_nodes[edge_type.dst],
            pad_multiple=pad_multiple, device=device,
        )


def save_hetero_graph(path: str, g: HeteroGraph) -> None:
    """Persist as a single .npz (the JAX package's keys, so either package
    reads the other's file)."""
    payload: Dict[str, np.ndarray] = {}
    for t, x in g.node_features.items():
        payload[f"x__{t}"] = x
    for t, x in g.node_features_float.items():
        payload[f"xf__{t}"] = x
    for et, (s, d) in g.edges.items():
        key = f"{et.src}|{et.rel}|{et.dst}"
        payload[f"es__{key}"] = s
        payload[f"ed__{key}"] = d
    payload["__num_nodes_keys"] = np.array(list(g.num_nodes.keys()))
    payload["__num_nodes_vals"] = np.array(list(g.num_nodes.values()), dtype=np.int64)
    np.savez_compressed(path, **payload)


def load_hetero_graph(path: str) -> HeteroGraph:
    with np.load(path, allow_pickle=False) as z:
        node_features, node_features_float, edges = {}, {}, {}
        for k in z.files:
            if k.startswith("x__"):
                node_features[k[3:]] = z[k]
            elif k.startswith("xf__"):
                node_features_float[k[4:]] = z[k]
            elif k.startswith("es__"):
                src, rel, dst = k[4:].split("|")
                edges[EdgeType(src, rel, dst)] = (z[k], z["ed__" + k[4:]])
        num_nodes = dict(zip([str(s) for s in z["__num_nodes_keys"]],
                             [int(v) for v in z["__num_nodes_vals"]]))
    return HeteroGraph(node_features, edges, num_nodes, node_features_float)
