"""Data bundle for the hetero encoder-decoder (link prediction) pipeline —
the port of the JAX package's ``data/link_pred_data.py`` (reference
``data/data_loader.py:14-65``).

Per cumulative split (train ⊂ train+val ⊂ train+val+test) a pair of host CSR
adjacencies feeding the subgraph sampler, matchers for the eval splits, and
the full feature tables, held once as tensors on the device.

Not ported yet: the graph-store sampler; it comes with the periphery.
"""
from __future__ import annotations

import dataclasses as dc
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs import Config
from ..constants import EDGE_KEY, EDGE_KEY_EXTRA, NODE_EXTRA, NODE_ITEM, NODE_USER
from .graph import HeteroGraph, HostCSR
from .matchers import Matcher, get_matchers
from .sampler import SubgraphSampler, derive_budgets
from .splitting import train_test_split_by_time


@dataclass
class SplitAdjacency:
    user_csr: HostCSR
    item_csr: HostCSR


@dataclass
class LinkPredData:
    num_users: int
    num_items: int
    user_features: torch.Tensor  # int64 [U, F_u] device table
    item_features: torch.Tensor  # int64 [I, F_i]
    splits: Dict[str, SplitAdjacency]       # cumulative: train/val/test
    matchers: Dict[str, List[Matcher]]      # for val/test
    graph: HeteroGraph
    user_features_float: Optional[torch.Tensor] = None  # f32 [U, Dfu]
    item_features_float: Optional[torch.Tensor] = None  # f32 [I, Dfi] (CLIP)
    item_extra_ids: Optional[torch.Tensor] = None  # int64 [I] colour group/item
    num_extra: int = 0                             # distinct colour groups
    extra_features: Optional[torch.Tensor] = None  # int64 [num_extra, F_e]

    @property
    def device(self) -> torch.device:
        return self.user_features.device

    def float_dims(self) -> Dict[str, int]:
        return {
            NODE_USER: 0 if self.user_features_float is None
            else int(self.user_features_float.shape[1]),
            NODE_ITEM: 0 if self.item_features_float is None
            else int(self.item_features_float.shape[1]),
        }


def _tensor(a, dtype, dev) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dtype))).to(dev)


def create_link_pred_data(
    g: HeteroGraph,
    cfg: Config,
    popular_items: Optional[np.ndarray] = None,
    lightgcn_artifact: Optional[str] = None,
    sorted_by_time: bool = True,
    device="cuda",
) -> LinkPredData:
    """Split the ``buys`` edges chronologically (leave-last-2, reference
    ``run_data_splitting.py:36-52``), build the cumulative split adjacencies
    and matchers, and put the feature tables on ``device``. Edge order in
    ``g`` is taken as chronological."""
    dev = resolve_device(device)
    eu, ei = g.edges[EDGE_KEY]
    eu = np.asarray(eu, np.int64)
    ei = np.asarray(ei, np.int64)
    num_users = g.num_nodes[EDGE_KEY.src]
    num_items = g.num_nodes[EDGE_KEY.dst]

    tr, va, te = train_test_split_by_time(eu)
    cum = {"train": tr, "val": tr | va, "test": tr | va | te}
    splits = {
        name: SplitAdjacency(
            user_csr=HostCSR.from_edges(eu[mask], ei[mask], num_users, num_items),
            item_csr=HostCSR.from_edges(ei[mask], eu[mask], num_items, num_users),
        )
        for name, mask in cum.items()
    }
    matchers = {
        name: get_matchers(
            cfg.matchers, cfg.candidate_pool_size,
            splits[name].user_csr, splits[name].item_csr,
            popular_items=popular_items, lightgcn_artifact=lightgcn_artifact,
        )
        for name in ("val", "test")
    }
    extra_ids, num_extra, extra_feats = _extract_extra(g, num_items)
    return LinkPredData(
        num_users=num_users,
        num_items=num_items,
        user_features=_tensor(g.node_features[EDGE_KEY.src], np.int64, dev),
        item_features=_tensor(g.node_features[EDGE_KEY.dst], np.int64, dev),
        splits=splits,
        matchers=matchers,
        graph=g,
        user_features_float=_tensor(g.node_features_float.get(EDGE_KEY.src), np.float32, dev),
        item_features_float=_tensor(g.node_features_float.get(EDGE_KEY.dst), np.float32, dev),
        item_extra_ids=_tensor(extra_ids, np.int64, dev),
        num_extra=num_extra,
        extra_features=_tensor(extra_feats, np.int64, dev),
    )


def create_link_pred_data_from_artifacts(
    artifact_dir: str, cfg: Config, device="cuda",
) -> Tuple[LinkPredData, "LinkPredArtifacts"]:
    """Load preprocessed artifacts and build the data bundle on ``device``
    with the saved split masks (preprocess and train as separate processes,
    the reference's ``data/derived`` hand-off; JAX ``:147-195``)."""
    from .etl import load_artifacts

    dev = resolve_device(device)
    a = load_artifacts(artifact_dir)
    eu, ei = a.graph.edges[EDGE_KEY]
    eu = np.asarray(eu, np.int64)
    ei = np.asarray(ei, np.int64)
    num_users = a.graph.num_nodes[EDGE_KEY.src]
    num_items = a.graph.num_nodes[EDGE_KEY.dst]
    cum = {
        "train": a.train_mask,
        "val": a.train_mask | a.val_mask,
        "test": a.train_mask | a.val_mask | a.test_mask,
    }
    splits = {
        name: SplitAdjacency(
            user_csr=HostCSR.from_edges(eu[m], ei[m], num_users, num_items),
            item_csr=HostCSR.from_edges(ei[m], eu[m], num_items, num_users),
        )
        for name, m in cum.items()
    }
    matchers = {
        name: get_matchers(
            cfg.matchers, cfg.candidate_pool_size,
            splits[name].user_csr, splits[name].item_csr,
            popular_items=a.popular_items,
        )
        for name in ("val", "test")
    }
    g = a.graph
    data = LinkPredData(
        num_users=num_users,
        num_items=num_items,
        user_features=_tensor(g.node_features[EDGE_KEY.src], np.int64, dev),
        item_features=_tensor(g.node_features[EDGE_KEY.dst], np.int64, dev),
        splits=splits,
        matchers=matchers,
        graph=g,
        user_features_float=_tensor(g.node_features_float.get(EDGE_KEY.src), np.float32, dev),
        item_features_float=_tensor(g.node_features_float.get(EDGE_KEY.dst), np.float32, dev),
    )
    return data, a


def _extract_extra(g: HeteroGraph, num_items: int):
    """Optional ``item —has_color→ colour_group`` edges → per-item map
    (numpy): the extra edge list carries one colour group per item, so it
    collapses into an [num_items] lookup the encoder reads directly; items
    without a ``has_color`` edge carry -1 (no message either way)."""
    if EDGE_KEY_EXTRA not in g.edges:
        return None, 0, None
    src, dst = g.edges[EDGE_KEY_EXTRA]
    num_extra = int(g.num_nodes.get(EDGE_KEY_EXTRA.dst, int(np.max(dst, initial=0)) + 1))
    m = np.full(num_items, -1, np.int32)
    m[np.asarray(src, np.int64)] = np.asarray(dst, np.int32)
    return m, num_extra, g.node_features.get(NODE_EXTRA)


def _probe_budgets(cfg, data, budgets, seed, randomization):
    """Tighten the big pad budgets to probed usage (``cfg.budget_probe``):
    sample ``budget_probe`` batches per split under the static worst-case
    budgets and shrink the node/edge slots to observed-max × 1.5 (rounded up
    to 128, never above the static derivation). The label grid keeps its
    static width; the runtime truncation counters stay the guard."""
    rng = np.random.default_rng((seed + 1) * 7919)
    max_u = max_i = max_e = 1
    for split, train, matchers in (
        ("train", True, None),
        ("val", False, data.matchers["val"]),
        ("test", False, data.matchers["test"]),
    ):
        adj = data.splits[split]
        s = SubgraphSampler(
            cfg, adj.user_csr, adj.item_csr, train=train, matchers=matchers,
            randomization=randomization, seed=seed + 31, budgets=budgets,
        )
        for _ in range(int(cfg.budget_probe)):
            b = s.sample_batch(rng.integers(0, data.num_users, cfg.batch_size))
            max_u = max(max_u, int(np.asarray(b.user_mask).sum()))
            max_i = max(max_i, int(np.asarray(b.item_mask).sum()))
            max_e = max(max_e, int(np.asarray(b.edge_mask).sum()))

    def shrink(derived, observed):
        padded = -(-int(observed * 1.5) // 128) * 128
        return min(derived, max(padded, 128))

    return dc.replace(
        budgets,
        num_user_slots=shrink(budgets.num_user_slots, max_u),
        num_item_slots=shrink(budgets.num_item_slots, max_i),
        num_edges=shrink(budgets.num_edges, max_e),
    )


def create_samplers(
    cfg: Config, data: LinkPredData, seed: int = 0, randomization: bool = True,
) -> Tuple[SubgraphSampler, SubgraphSampler, SubgraphSampler]:
    """(train, val, test) samplers sharing one budget set, so every batch of
    a run has the same shapes (reference ``create_dataloaders``,
    ``data/data_loader.py:14-65``)."""
    max_deg = max(
        int(adj.user_csr.degrees.max(initial=1)) for adj in data.splits.values()
    )
    budgets = derive_budgets(
        cfg, max_deg, max(len(m) for m in data.matchers.values()),
        num_users=data.num_users, num_items=data.num_items,
    )
    if cfg.budget_probe:
        budgets = _probe_budgets(cfg, data, budgets, seed, randomization)

    def make(split: str, train: bool, matchers, seed_off: int):
        adj = data.splits[split]
        return SubgraphSampler(
            cfg, adj.user_csr, adj.item_csr, train=train, matchers=matchers,
            randomization=randomization, seed=seed + seed_off, budgets=budgets,
        )

    return (
        make("train", True, None, 0),
        make("val", False, data.matchers["val"], 1),
        make("test", False, data.matchers["test"], 2),
    )
