"""PinSAGE data layer: random-walk importance sampling → padded blocks — the
port of the JAX package's ``data/pinsage_data.py`` (reference
``pinsage/sampler.py:16-186``, ``pinsage/builder.py``,
``pinsage/process_hm.py``):

* item triples (head, tail, neg_tail) whose tail comes from an
  item→user→item walk (``sampler.py:25-40``); walks that die are dropped,
* random-walk importance neighbourhoods: per seed item ``num_random_walks``
  restart walks, the ``num_neighbors`` most-visited items become its
  frontier with the visit counts as edge weights
  (``dgl.sampling.PinSAGESampler``, ``sampler.py:60-71``),
* leak prevention: frontier edges joining a batch's (head, tail) or (head,
  neg_tail) pairs are dropped (``sampler.py:77-87``),
* block compaction into fixed-size, index-remapped :class:`PinSAGEBlock`\\ s.

Sampling is host numpy (and the port's native library) and draws from one
``np.random.default_rng(seed)`` in the JAX package's order, so one seed gives
the JAX package's arrays on either path. Blocks and batches hold numpy
arrays; ``.to(device)`` gives the same dataclass of tensors on a device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import EDGE_KEY
from .etl import LinkPredArtifacts
from .graph import HostCSR
from .sampler import array_to


@dataclass
class PinSAGEBlock:
    """One message-flow block: src item slots → dst item slots."""

    src_ids: np.ndarray    # int32 [S] global item ids (pad → 0)
    dst_ids: np.ndarray    # int32 [D] global item ids
    src_mask: np.ndarray   # bool [S]
    dst_mask: np.ndarray   # bool [D]
    edge_src: np.ndarray   # int32 [E] local src slot
    edge_dst: np.ndarray   # int32 [E] local dst slot
    edge_w: np.ndarray     # float32 [E] visit counts (0 on pads)

    def to(self, device) -> "PinSAGEBlock":
        """The block as tensors on ``device`` (integers as int64; copies to
        the card non-blocking, through pinned memory)."""
        dev = torch.device(device)
        return PinSAGEBlock(**{f.name: array_to(getattr(self, f.name), dev)
                               for f in dataclasses.fields(self)})


@dataclass
class PinSAGEBatch:
    """Blocks + compacted pos/neg pairs."""

    blocks: List[PinSAGEBlock]
    pos_head: np.ndarray   # int32 [P] slot into blocks[-1].dst
    pos_tail: np.ndarray
    neg_head: np.ndarray
    neg_tail: np.ndarray
    pair_mask: np.ndarray  # bool [P]

    def to(self, device) -> "PinSAGEBatch":
        dev = torch.device(device)
        return PinSAGEBatch(
            blocks=[b.to(dev) for b in self.blocks],
            **{f.name: array_to(getattr(self, f.name), dev)
               for f in dataclasses.fields(self) if f.name != "blocks"},
        )


@dataclass
class PinSAGEData:
    """Dataset bundle — the ``pinsage_dataset.pkl`` equivalent
    (``pinsage/process_hm.py:9-57``)."""

    num_users: int
    num_items: int
    user_csr: HostCSR       # train user→items
    item_csr: HostCSR       # train item→users
    item_features: np.ndarray           # int32 [I, F] categorical
    item_features_float: Optional[np.ndarray]  # float32 [I, D] or None
    latest_item_per_user: np.ndarray    # int32 [U] last train interaction
    val_items: List[np.ndarray]         # per-user val ground truth
    test_items: List[np.ndarray]


def _per_user(users: np.ndarray, items: np.ndarray, num_users: int) -> List[np.ndarray]:
    """Each user's items in edge order (int64; empty for a user without
    one) — the JAX loop ``items[users == u]`` in one stable sort."""
    order = np.argsort(users, kind="stable")
    bounds = np.searchsorted(users[order], np.arange(num_users + 1))
    grouped = items[order]
    return [grouped[bounds[u]:bounds[u + 1]] for u in range(num_users)]


def build_pinsage_data(a: LinkPredArtifacts) -> PinSAGEData:
    """From preprocessed artifacts (chronological edge order): train CSRs, the
    latest train interaction per user, per-user val/test item sets. The
    arrays equal the JAX function's; its per-user Python loops are sorts
    here, so a graph of H&M size builds in seconds."""
    g = a.graph
    eu, ei = g.edges[EDGE_KEY]
    eu = np.asarray(eu, np.int64)
    ei = np.asarray(ei, np.int64)
    num_users = g.num_nodes[EDGE_KEY.src]
    num_items = g.num_nodes[EDGE_KEY.dst]
    tr = a.train_mask
    u_tr, i_tr = eu[tr], ei[tr]

    # the last train interaction per user in chronological order; users with
    # no train history keep -1 and are left out of latest-item retrieval
    latest = np.full(num_users, -1, np.int32)
    users_rev, last = np.unique(u_tr[::-1], return_index=True)
    latest[users_rev] = i_tr[::-1][last]

    ff = g.node_features_float.get(EDGE_KEY.dst)
    return PinSAGEData(
        num_users=num_users,
        num_items=num_items,
        user_csr=HostCSR.from_edges(u_tr, i_tr, num_users, num_items),
        item_csr=HostCSR.from_edges(i_tr, u_tr, num_items, num_users),
        item_features=g.node_features[EDGE_KEY.dst].astype(np.int32),
        item_features_float=ff.astype(np.float32) if ff is not None else None,
        latest_item_per_user=latest,
        val_items=_per_user(eu[a.val_mask], ei[a.val_mask], num_users),
        test_items=_per_user(eu[a.test_mask], ei[a.test_mask], num_users),
    )


class PinSAGESampler:
    """Random-walk importance neighbourhoods + block assembly.

    ``use_native`` takes the native frontier and walk step when the library
    builds; :attr:`path` says which ran (``"native"`` or ``"python"``)."""

    def __init__(
        self,
        data: PinSAGEData,
        random_walk_length: int = 2,
        random_walk_restart_prob: float = 0.5,
        num_random_walks: int = 10,
        num_neighbors: int = 3,
        num_layers: int = 2,
        batch_size: int = 32,
        seed: int = 0,
        use_native: bool = True,
    ):
        self.d = data
        from .. import native as _native

        self._native = _native if (use_native and _native.available()) else None
        self.walk_length = random_walk_length
        self.restart_prob = random_walk_restart_prob
        self.num_walks = num_random_walks
        self.num_neighbors = num_neighbors
        self.num_layers = num_layers
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        # id→slot array: each batch and layer only looks up ids it has just
        # written, so stale entries are never read
        self._slot = np.zeros(data.num_items, np.int32)
        # static slot budgets per layer (innermost → outermost)
        self.dst_budget = []
        self.src_budget = []
        n = 3 * batch_size  # compacted heads+tails+negs upper bound
        for _ in range(num_layers):
            self.dst_budget.append(n)
            n = n * (1 + num_neighbors)
            self.src_budget.append(n)

    @property
    def path(self) -> str:
        return "python" if self._native is None else "native"

    # -- random walks ------------------------------------------------------

    def _walk_step(self, items: np.ndarray) -> np.ndarray:
        """One item→user→item metapath traversal; dead ends return -1."""
        if self._native is not None:
            return self._native.walk_step(
                self.d.user_csr.row_ptr, self.d.user_csr.cols,
                self.d.item_csr.row_ptr, self.d.item_csr.cols,
                items, int(self.rng.integers(0, 2 ** 62)),
            )
        out = np.full(len(items), -1, np.int64)
        for idx, it in enumerate(items):
            if it < 0:
                continue
            users = self.d.item_csr.neighbors(int(it))
            if len(users) == 0:
                continue
            u = users[self.rng.integers(len(users))]
            its = self.d.user_csr.neighbors(int(u))
            if len(its) == 0:
                continue
            out[idx] = its[self.rng.integers(len(its))]
        return out

    def neighbor_frontier(self, seeds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-``num_neighbors`` visited items per seed with visit counts:
        edges neighbour→seed, weight = count."""
        if self._native is not None:
            return self._native.pinsage_frontier(
                self.d.user_csr.row_ptr, self.d.user_csr.cols,
                self.d.item_csr.row_ptr, self.d.item_csr.cols,
                np.asarray(seeds, np.int32),
                self.walk_length, self.restart_prob,
                self.num_walks, self.num_neighbors,
                int(self.rng.integers(0, 2 ** 62)),
            )
        n = len(seeds)
        counts: List[Dict[int, int]] = [dict() for _ in range(n)]
        for _ in range(self.num_walks):
            cur = seeds.astype(np.int64).copy()
            for _step in range(self.walk_length):
                cur = self._walk_step(cur)
                for idx, it in enumerate(cur):
                    if it >= 0:
                        counts[idx][int(it)] = counts[idx].get(int(it), 0) + 1
                # restart at the seed with probability restart_prob
                restart = self.rng.random(n) < self.restart_prob
                cur = np.where(restart | (cur < 0), seeds, cur)
        srcs, dsts, ws = [], [], []
        for idx, c in enumerate(counts):
            c.pop(int(seeds[idx]), None)  # self-visits are not neighbours
            top = sorted(c.items(), key=lambda kv: (-kv[1], kv[0]))[: self.num_neighbors]
            for it, w in top:
                srcs.append(it)
                dsts.append(int(seeds[idx]))
                ws.append(float(w))
        return np.array(srcs, np.int64), np.array(dsts, np.int64), np.array(ws, np.float32)

    # -- batch sampling ----------------------------------------------------

    def sample_item_triples(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(heads, tails, neg_tails) — ``ItemToItemBatchSampler``
        (``pinsage/sampler.py:25-40``)."""
        heads = self.rng.integers(0, self.d.num_items, self.batch_size)
        tails = self._walk_step(heads.astype(np.int64))
        neg_tails = self.rng.integers(0, self.d.num_items, self.batch_size)
        mask = tails >= 0
        return heads[mask], tails[mask], neg_tails[mask]

    def sample_blocks(
        self, seeds: np.ndarray, forbidden_pairs: Optional[set] = None,
    ) -> Tuple[List[PinSAGEBlock], np.ndarray]:
        """L compacted blocks, outermost first (``sample_blocks``,
        ``pinsage/sampler.py:73-91``). Returns (blocks, final_dst_ids)."""
        blocks_rev: List[PinSAGEBlock] = []
        seeds = np.asarray(seeds, np.int64)
        d_b0 = self.dst_budget[0]
        assert len(seeds) <= d_b0, (len(seeds), d_b0)
        # the src layout of an inner block IS the dst layout of the next
        # (outer) one, so the model's prefix slice h[:dst_budget] stays aligned
        cur_ids = np.zeros(d_b0, np.int64)
        cur_ids[: len(seeds)] = seeds
        cur_mask = np.arange(d_b0) < len(seeds)

        # key-encoded forbidden pairs for a vectorized isin filter
        ni = self.d.num_items
        fkeys = (
            np.fromiter((int(s) * ni + int(d) for s, d in forbidden_pairs),
                        np.int64, count=len(forbidden_pairs))
            if forbidden_pairs else None
        )

        for layer in range(self.num_layers):
            valid = cur_ids[cur_mask]
            fs, fd, fw = self.neighbor_frontier(valid)
            if fkeys is not None and len(fs):
                keep = ~np.isin(fs * ni + fd, fkeys)
                fs, fd, fw = fs[keep], fd[keep], fw[keep]
            extra = np.setdiff1d(np.unique(fs), valid)
            s_b, d_b = self.src_budget[layer], self.dst_budget[layer]
            assert d_b == len(cur_ids) and d_b + len(extra) <= s_b

            self._slot[cur_ids[cur_mask]] = np.flatnonzero(cur_mask).astype(np.int32)
            self._slot[extra] = (d_b + np.arange(len(extra))).astype(np.int32)

            src_ids = np.zeros(s_b, np.int64)
            src_ids[:d_b] = cur_ids
            src_ids[d_b: d_b + len(extra)] = extra
            src_mask = np.zeros(s_b, bool)
            src_mask[:d_b] = cur_mask
            src_mask[d_b: d_b + len(extra)] = True

            e_b = d_b * self.num_neighbors
            e = len(fs)
            edge_src = np.zeros(e_b, np.int32)
            edge_dst = np.zeros(e_b, np.int32)
            edge_w = np.zeros(e_b, np.float32)
            edge_src[:e] = self._slot[fs]
            edge_dst[:e] = self._slot[fd]
            edge_w[:e] = fw
            blocks_rev.append(PinSAGEBlock(
                src_ids=src_ids.astype(np.int32),
                dst_ids=cur_ids.astype(np.int32).copy(),
                src_mask=src_mask,
                dst_mask=cur_mask.copy(),
                edge_src=edge_src,
                edge_dst=edge_dst,
                edge_w=edge_w,
            ))
            cur_ids, cur_mask = src_ids, src_mask
        blocks = list(reversed(blocks_rev))  # outermost first, like DGL
        return blocks, np.asarray(blocks_rev[0].dst_ids)

    def sample_train_batch(self) -> Optional[PinSAGEBatch]:
        """(pos pairs, neg pairs, blocks) — ``sample_from_item_pairs``
        (``pinsage/sampler.py:93-106``); None when every walk died."""
        heads, tails, neg_tails = self.sample_item_triples()
        if len(heads) == 0:
            return None
        seeds = np.unique(np.concatenate([heads, tails, neg_tails]))
        forbidden = set(
            [(int(t), int(h)) for h, t in zip(heads, tails)]
            + [(int(t), int(h)) for h, t in zip(heads, neg_tails)]
            + [(int(h), int(t)) for h, t in zip(heads, tails)]
            + [(int(h), int(t)) for h, t in zip(heads, neg_tails)]
        )
        blocks, _ = self.sample_blocks(seeds, forbidden_pairs=forbidden)
        # the seeds were the innermost dst layout
        self._slot[seeds] = np.arange(len(seeds), dtype=np.int32)
        p = self.batch_size
        n = len(heads)
        pos_head = np.zeros(p, np.int32)
        pos_tail = np.zeros(p, np.int32)
        neg_head = np.zeros(p, np.int32)
        neg_tail = np.zeros(p, np.int32)
        mask = np.zeros(p, bool)
        pos_head[:n] = self._slot[heads]
        pos_tail[:n] = self._slot[tails]
        neg_head[:n] = self._slot[heads]
        neg_tail[:n] = self._slot[neg_tails]
        mask[:n] = True
        return PinSAGEBatch(blocks=blocks, pos_head=pos_head, pos_tail=pos_tail,
                            neg_head=neg_head, neg_tail=neg_tail, pair_mask=mask)
