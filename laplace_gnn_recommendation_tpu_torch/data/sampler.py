"""Padded N-hop subgraph sampler — the port of the JAX package's
``data/sampler.py`` (the reference's ``GraphDataset.__getitem__`` + PyG
DataLoader worker stack, ``data/dataset.py:39-182``,
``data/data_loader.py:48-50``).

Sampling stays on the host in numpy and the native C++ library, driven by
``np.random.default_rng(seed)`` exactly as in the JAX package, so one seed
gives the JAX package's batches array for array. A batch moves to the device
in one place, :meth:`SubgraphBatch.to`.

One call produces a whole :class:`SubgraphBatch` for B seed users with fully
static shapes:

* node slots carry **global** ids (the model gathers features/embeddings from
  full device-resident tables — no per-batch feature copies),
* subgraph edges in local slot coordinates (the ``t.bucketize`` remap of
  ``data/dataset.py:233-241`` becomes a vectorized ``np.searchsorted``),
* label edges laid out as a dense [B, L] per-user grid, which makes the
  decoder, the BCE loss *and* per-user eval ranking trivially vectorizable
  (the reference re-groups scores per user with a ragged ``padded_stack`` at
  ``model/encoder_decoder.py:155-164``).

Sampling semantics preserved from ``data/dataset.py``:

* positive sampling: ``max(1, floor(|pos| · positive_edges_ratio))`` draws
  **with replacement** (``t.randint``, ``:57-69``); deterministic mode takes
  [argmin, argmax] of the item ids (``:61-67``) — the hook the golden-subgraph
  oracle tests rely on,
* negative sampling (train): uniform in [0, max_item_id) without positive
  filtering when edges/negatives > 100, else a filtered permutation
  (``:190-230``); deterministic mode yields [max_item_id],
* negative sampling (eval): matcher candidates XOR positives via the
  count==1 trick (``:93-106``) — including the reference's quirk that
  positives *not* proposed by any matcher enter the label set with label 0;
  ground truth for ranking metrics is carried separately so eval is unaffected,
* N-hop BFS with per-hop ``num_neighbors`` frontier caps, user dedup, and
  the seed user's own edges excluded from the hop edges (``:258-293``).

Static-shape discipline: per-user budgets are computed from the config and
the graph's max degree; anything beyond a budget is dropped and counted in
``self.truncations`` (never silently).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import Config
from .graph import HostCSR


@dataclass
class SubgraphBatch:
    """One padded batch of per-user subgraphs: numpy arrays as the sampler
    builds them, torch tensors after :meth:`to`."""

    user_ids: np.ndarray     # int32 [NU] global user ids (pad → 0)
    item_ids: np.ndarray     # int32 [NI] global item ids (pad → 0)
    user_mask: np.ndarray    # bool [NU]
    item_mask: np.ndarray    # bool [NI]
    edge_src: np.ndarray     # int32 [E] local user slot
    edge_dst: np.ndarray     # int32 [E] local item slot
    edge_mask: np.ndarray    # bool [E]
    label_src: np.ndarray    # int32 [B, L] local user slot
    label_dst: np.ndarray    # int32 [B, L] local item slot
    label: np.ndarray        # float32 [B, L]
    label_mask: np.ndarray   # bool [B, L]
    label_item_global: np.ndarray  # int32 [B, L]
    seed_users: np.ndarray   # int32 [B] global ids
    seed_slots: np.ndarray   # int32 [B] local user slot of each seed
    gt_items: np.ndarray     # int32 [B, G] global gt items (eval); pad → -1
    gt_count: np.ndarray     # int32 [B]

    def to(self, device) -> "SubgraphBatch":
        """The batch as tensors on ``device``: integer arrays as int64 (the
        index type of ``index_put_`` / ``scatter_reduce``), masks as bool,
        labels as f32. For the card each array goes through pinned host
        memory with a non-blocking copy, so the upload queues behind the
        device's work instead of waiting for it."""
        dev = torch.device(device)
        return SubgraphBatch(**{f.name: array_to(getattr(self, f.name), dev)
                                for f in dataclasses.fields(self)})


def array_to(a, dev: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on ``dev``, integers as int64.
    For the card it goes through pinned host memory with a non-blocking
    copy, so the upload queues behind the device's work instead of waiting
    for it."""
    pin = dev.type == "cuda"
    if isinstance(a, torch.Tensor):
        return a.to(dev, non_blocking=pin)
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if pin:
        t = t.pin_memory()
    return t.to(dev, non_blocking=pin)


@dataclass
class SamplerBudgets:
    """Static per-batch pad sizes."""

    num_user_slots: int
    num_item_slots: int
    num_edges: int
    labels_per_user: int
    gt_per_user: int


def derive_budgets(
    cfg: Config,
    max_user_degree: int,
    num_matchers: int = 1,
    num_users: Optional[int] = None,
    num_items: Optional[int] = None,
) -> SamplerBudgets:
    """Derive exact (non-truncating for typical graphs) pad sizes from config
    + graph stats; any field can be overridden via config. Node-slot budgets
    clamp at the graph's node counts — a batch can never touch more distinct
    nodes than exist."""
    d = max(int(max_user_degree), 1)
    pos_cap = max(1, int(np.floor(d * cfg.positive_edges_ratio)))
    neg_cap = max(int(np.ceil(cfg.negative_edges_ratio * pos_cap)), cfg.k - 1)
    # eval candidates: matcher pool + all positives (XOR quirk)
    labels = cfg.max_labels_per_user or max(
        pos_cap + neg_cap, pos_cap + cfg.candidate_pool_size * num_matchers + d
    )
    b = cfg.batch_size
    n_hops = max(cfg.n_hop_neighbors, 1)
    # users touched per seed: 1 + num_neighbors per deeper hop
    users_per_seed = 1 + cfg.num_neighbors * max(n_hops - 1, 1)
    edges_per_seed = d + cfg.num_neighbors * max(n_hops - 1, 1) * min(
        d, 4 * cfg.num_neighbors
    )
    edges = cfg.max_edges_per_batch or b * edges_per_seed
    items_per_seed = edges_per_seed + labels
    user_slots = b * users_per_seed
    item_slots = b * items_per_seed
    if num_users is not None:
        user_slots = min(user_slots, num_users)
    if num_items is not None:
        item_slots = min(item_slots, num_items)
    return SamplerBudgets(
        num_user_slots=user_slots,
        num_item_slots=item_slots,
        num_edges=edges,
        labels_per_user=labels,
        gt_per_user=d,
    )


class SubgraphSampler:
    """Host-side batch sampler over CSR adjacency.

    Parameters
    ----------
    user_csr / item_csr : HostCSR
        user→items and item→users adjacency of the split's cumulative graph
        (the reference's ``edges_{split}.pt`` / ``rev_edges_{split}.pt`` dicts).
    train : bool
        train → random negatives; eval → matcher candidates (XOR positives).
    matchers : candidate generators (required when ``train=False``), each with
        a ``get_matches(user_id) -> np.ndarray`` method.
    randomization : False switches to the deterministic oracle mode used by
        the golden-subgraph tests (reference ``data/dataset.py:24,57-67``).
    """

    def __init__(
        self,
        cfg: Config,
        user_csr: HostCSR,
        item_csr: HostCSR,
        train: bool,
        matchers: Optional[Sequence] = None,
        randomization: bool = True,
        seed: int = 0,
        budgets: Optional[SamplerBudgets] = None,
        use_native: bool = True,
    ):
        self.cfg = cfg
        self.users = user_csr
        self.items = item_csr
        self.train = train
        self.matchers = list(matchers or [])
        if not train:
            assert self.matchers, "Must provide matchers for eval sampling"
        self.randomization = randomization
        self.rng = np.random.default_rng(seed)
        self.num_users = user_csr.num_rows
        self.num_items = user_csr.num_cols
        max_deg = int(user_csr.degrees.max(initial=1))
        self.budgets = budgets or derive_budgets(
            cfg, max_deg, max(len(self.matchers), 1),
            num_users=self.num_users, num_items=self.num_items,
        )
        self.truncations: Dict[str, int] = {"edges": 0, "labels": 0, "nodes": 0}
        # max item id with at least one edge — the reference samples negatives
        # in [0, id_max) where id_max = max item id present (dataset.py:198)
        self.id_max = int(item_csr.degrees.nonzero()[0].max(initial=0))
        # native C++ BFS fast path (deterministic oracle mode stays in
        # Python so golden-subgraph tests pin the exact reference semantics)
        from .. import native as _native

        self._native = _native if (use_native and _native.available()) else None

    # ---- per-user pieces -------------------------------------------------

    def _sample_positives(self, positives: np.ndarray) -> np.ndarray:
        """Returns draw *indices* into ``positives`` (values = positives[draws])."""
        n = len(positives)
        cut = max(1, int(np.floor(n * self.cfg.positive_edges_ratio)))
        if self.randomization:
            return self.rng.integers(0, n, size=cut)  # with replacement
        return np.array([int(np.argmin(positives)), int(np.argmax(positives))])

    def _sample_negatives_train(
        self, sampled_pos: np.ndarray, num_neg: int
    ) -> np.ndarray:
        total_edges = self.users.cols.shape[0]
        if num_neg <= 0:
            return np.empty(0, np.int64)
        if total_edges / num_neg > 100:
            if self.randomization:
                return self.rng.integers(0, max(self.id_max, 1), size=num_neg)
            return np.array([self.id_max])
        pool = np.arange(self.id_max + 1)
        only_neg = np.setdiff1d(pool, sampled_pos, assume_unique=False)
        if self.randomization:
            self.rng.shuffle(only_neg)
            return only_neg[:num_neg]
        return np.array([self.id_max])

    def _candidates_eval(self, user: int, positives: np.ndarray) -> np.ndarray:
        cands = np.unique(
            np.concatenate([np.asarray(m.get_matches(user)).ravel() for m in self.matchers])
        ) if self.matchers else np.empty(0, np.int64)
        # count==1 trick of dataset.py:101-106: candidates XOR positives
        merged = np.concatenate([cands, positives])
        uniq, counts = np.unique(merged, return_counts=True)
        return uniq[counts == 1]

    def _cut(self, arr: np.ndarray, n: int) -> np.ndarray:
        if len(arr) > n:
            if self.randomization:
                return self.rng.choice(arr, size=n, replace=False)
            return arr[:n]
        return arr

    def _n_hop_edges(self, user: int) -> Tuple[np.ndarray, np.ndarray]:
        """BFS hop edges (excluding the seed's own direct edges) —
        reference ``fetch_n_hop_neighbourhood`` (``data/dataset.py:258-293``)."""
        n = self.cfg.n_hop_neighbors
        cap = self.cfg.num_neighbors
        src_acc: List[np.ndarray] = []
        dst_acc: List[np.ndarray] = []
        explored = {user}
        queue = np.array([user], dtype=np.int64)
        for hop in range(n):
            if len(queue) == 0:
                break
            arts = [self.users.neighbors(int(u)) for u in queue]
            if hop != 0:
                for u, a in zip(queue, arts):
                    src_acc.append(np.full(len(a), u, np.int64))
                    dst_acc.append(a.astype(np.int64))
            new_articles = np.concatenate(arts) if arts else np.empty(0, np.int64)
            articles_queue = self._cut(new_articles, cap)
            nbr_users = (
                np.concatenate([self.items.neighbors(int(a)) for a in articles_queue])
                if len(articles_queue)
                else np.empty(0, np.int64)
            )
            new_users = np.setdiff1d(np.unique(nbr_users), np.fromiter(explored, np.int64))
            explored.update(int(u) for u in queue)
            explored.update(int(u) for u in new_users)
            queue = np.asarray(self._cut(new_users, cap), dtype=np.int64)
        if src_acc:
            return np.concatenate(src_acc), np.concatenate(dst_acc)
        return np.empty(0, np.int64), np.empty(0, np.int64)

    def _batch_n_hop_edges(self, seed_users: np.ndarray):
        """Hop edges for all seeds — one OpenMP-parallel native call when the
        C++ library is available and randomized sampling is on; per-seed
        Python BFS otherwise."""
        if self._native is not None and self.randomization:
            rng_seed = int(self.rng.integers(0, 2 ** 62))
            src, dst, off = self._native.nhop_sample(
                self.users.row_ptr, self.users.cols,
                self.items.row_ptr, self.items.cols,
                self.num_users, self.num_items,
                np.asarray(seed_users, np.int32),
                self.cfg.n_hop_neighbors, self.cfg.num_neighbors, rng_seed,
            )
            return [
                (src[off[i]: off[i + 1]].astype(np.int64),
                 dst[off[i]: off[i + 1]].astype(np.int64))
                for i in range(len(seed_users))
            ]
        return [self._n_hop_edges(int(u)) for u in seed_users]

    # ---- batch assembly --------------------------------------------------

    def sample_batch(
        self, seed_users: np.ndarray, valid_rows: Optional[int] = None
    ) -> SubgraphBatch:
        """Build one padded batch for the given seed users.

        ``valid_rows`` < B marks trailing rows as padding (their labels and
        ground truth are masked out so loss/metrics ignore them).

        Slot assignment runs as ONE ``np.unique(..., return_inverse=True)``
        per node type over the whole batch — the inverse indices ARE the
        local slots, so no ``searchsorted``/``isin`` passes remain on the
        fast path (measured ~35% of batch time before). The budget-
        truncating path (rare: node sets exceeding their pad budgets) keeps
        the explicit membership-check semantics."""
        cfg, bud = self.cfg, self.budgets
        b = len(seed_users)
        valid_rows = b if valid_rows is None else valid_rows

        if self._native is not None and self.randomization:
            if self.train:
                batch = self._sample_batch_native(seed_users, b, valid_rows)
            else:
                # eval fast path: batched matcher candidates + one C++ call
                # (XOR-vs-positives happens natively; the latency-critical
                # RankingServer.recommend path rides this)
                cands = np.concatenate(
                    [
                        np.asarray(
                            m.get_matches_batch(seed_users), np.int64
                        ).reshape(len(seed_users), -1)
                        for m in self.matchers
                    ],
                    axis=1,
                ).astype(np.int32)
                if cands.shape[1] == 0:
                    # width 0 is the C side's TRAIN sentinel — keep eval
                    # semantics by padding one inert column (-1): the XOR
                    # then reduces to count-one over the positives alone,
                    # exactly the Python path's empty-candidates behavior
                    cands = np.full((len(seed_users), 1), -1, np.int32)
                batch = self._sample_batch_native(
                    seed_users, b, valid_rows, eval_cands=cands
                )
            if batch is not None:
                return batch

        hop_edges = self._batch_n_hop_edges(seed_users)
        per_user = []
        for row, u in enumerate(seed_users):
            u = int(u)
            positives = self.users.neighbors(u).astype(np.int64)
            draws = self._sample_positives(positives)
            sampled_pos = positives[draws]
            n_pos = len(sampled_pos)
            if self.train:
                ratio = (cfg.k - 1) if n_pos <= 1 else cfg.negative_edges_ratio
                negs = self._sample_negatives_train(sampled_pos, int(ratio * n_pos))
            else:
                negs = self._candidates_eval(u, positives)
            hop_src, hop_dst = hop_edges[row]
            per_user.append((u, positives, draws, sampled_pos, negs, hop_src, hop_dst))

        # node slot assignment: sorted unique global ids over the whole
        # batch; the inverse of each concat element is its local slot
        seeds_arr = np.array([p[0] for p in per_user], np.int64)
        all_users, uinv = np.unique(
            np.concatenate([seeds_arr] + [p[5] for p in per_user]),
            return_inverse=True,
        )
        i_parts = []
        for p in per_user:
            i_parts += [p[1], p[4], p[6]]
        all_items, iinv = np.unique(
            np.concatenate(i_parts) if i_parts else np.empty(0, np.int64),
            return_inverse=True,
        )

        if (
            len(all_users) > bud.num_user_slots
            or len(all_items) > bud.num_item_slots
        ):
            self.truncations["nodes"] += 1
            return self._assemble_truncated(per_user, b, valid_rows)

        l_max = bud.labels_per_user
        label = np.zeros((b, l_max), np.float32)
        label_mask = np.zeros((b, l_max), bool)
        label_item_global = np.zeros((b, l_max), np.int32)
        label_dst = np.zeros((b, l_max), np.int32)
        gt_items = np.full((b, bud.gt_per_user), -1, np.int32)
        gt_count = np.zeros(b, np.int32)
        seed_slots = uinv[:b].astype(np.int32)
        seeds = seeds_arr.astype(np.int32)

        esrc_l, edst_l = [], []
        u_off = b
        i_off = 0
        for row, (u, positives, draws, sampled_pos, negs, _hs, hop_dst) in enumerate(per_user):
            np_, nn, nh = len(positives), len(negs), len(hop_dst)
            pos_slots = iinv[i_off : i_off + np_]
            neg_slots = iinv[i_off + np_ : i_off + np_ + nn]
            hop_dst_slots = iinv[i_off + np_ + nn : i_off + np_ + nn + nh]
            i_off += np_ + nn + nh
            hop_src_slots = uinv[u_off : u_off + nh]
            u_off += nh

            esrc_l.append(np.full(np_, seed_slots[row], np.int64))
            edst_l.append(pos_slots)
            esrc_l.append(hop_src_slots)
            edst_l.append(hop_dst_slots)

            items = np.concatenate([sampled_pos, negs])
            slots = np.concatenate([pos_slots[draws], neg_slots])
            n_pos = len(sampled_pos)
            if len(items) > l_max:
                self.truncations["labels"] += len(items) - l_max
                items, slots = items[:l_max], slots[:l_max]
                n_pos = min(n_pos, l_max)
            c = len(items)
            label[row, :n_pos] = 1.0
            label_mask[row, :c] = True
            label_item_global[row, :c] = items
            label_dst[row, :c] = slots
            g = min(np_, bud.gt_per_user)
            gt_items[row, :g] = positives[:g]
            gt_count[row] = g

        esrc = np.concatenate(esrc_l)
        edst = np.concatenate(edst_l)
        if len(esrc) > bud.num_edges:
            self.truncations["edges"] += len(esrc) - bud.num_edges
            esrc, edst = esrc[: bud.num_edges], edst[: bud.num_edges]

        e_pad = bud.num_edges
        edge_src = np.zeros(e_pad, np.int32)
        edge_dst = np.zeros(e_pad, np.int32)
        edge_mask = np.zeros(e_pad, bool)
        edge_src[: len(esrc)] = esrc
        edge_dst[: len(esrc)] = edst
        edge_mask[: len(esrc)] = True

        label_src = np.where(label_mask, seed_slots[:, None], 0).astype(np.int32)
        label_dst = np.where(label_mask, label_dst, 0)
        if valid_rows < b:
            label_mask[valid_rows:] = False
            gt_count[valid_rows:] = 0

        return self._pack(
            all_users, all_items, edge_src, edge_dst, edge_mask,
            label_src, label_dst, label, label_mask, label_item_global,
            seeds, seed_slots, gt_items, gt_count,
        )

    def _sample_batch_native(
        self, seed_users: np.ndarray, b: int, valid_rows: int,
        eval_cands: Optional[np.ndarray] = None,
    ) -> Optional[SubgraphBatch]:
        """Whole-batch assembly in one C++ call (BFS + pos/neg sampling +
        slot maps + edge/label grids — ROADMAP device-side sampler stage).
        ``eval_cands`` ([B, W], -1 pads) switches negatives to the eval
        semantics (matcher candidates XOR positives). Returns None when a
        budget would overflow; the caller then runs the Python (truncating)
        path. RNG is the library's splitmix64 stream — distributionally
        equivalent to the numpy path, not bit-identical (same caveat as the
        native BFS)."""
        cfg, bud = self.cfg, self.budgets
        out = self._native.assemble_train_batch(
            self.users.row_ptr, self.users.cols,
            self.items.row_ptr, self.items.cols,
            self.num_users, self.num_items,
            np.asarray(seed_users, np.int32),
            cfg.n_hop_neighbors, cfg.num_neighbors,
            cfg.positive_edges_ratio, cfg.negative_edges_ratio, cfg.k,
            self.id_max, int(self.users.cols.shape[0]),
            int(self.rng.integers(0, 2 ** 62)),
            bud.num_user_slots, bud.num_item_slots, bud.num_edges,
            bud.labels_per_user, bud.gt_per_user,
            eval_cands=eval_cands,
        )
        if out is None:
            return None
        self.truncations["labels"] += out["label_truncations"]
        label_mask = out["label_mask"].view(np.bool_)
        gt_count = out["gt_count"]
        if valid_rows < b:
            label_mask[valid_rows:] = False
            gt_count[valid_rows:] = 0
        return SubgraphBatch(
            user_ids=out["user_ids"],
            item_ids=out["item_ids"],
            user_mask=out["user_mask"].view(np.bool_),
            item_mask=out["item_mask"].view(np.bool_),
            edge_src=out["edge_src"],
            edge_dst=out["edge_dst"],
            edge_mask=out["edge_mask"].view(np.bool_),
            label_src=out["label_src"],
            label_dst=out["label_dst"],
            label=out["label"],
            label_mask=label_mask,
            label_item_global=out["label_item_global"],
            seed_users=out["seeds_out"],
            seed_slots=out["seed_slots"],
            gt_items=out["gt_items"],
            gt_count=gt_count,
        )

    def _pack(
        self, all_users, all_items, edge_src, edge_dst, edge_mask,
        label_src, label_dst, label, label_mask, label_item_global,
        seeds, seed_slots, gt_items, gt_count,
    ) -> SubgraphBatch:
        bud = self.budgets
        nu, ni = bud.num_user_slots, bud.num_item_slots
        user_ids = np.zeros(nu, np.int32)
        user_ids[: len(all_users)] = all_users
        item_ids = np.zeros(ni, np.int32)
        item_ids[: len(all_items)] = all_items
        user_mask = np.arange(nu) < len(all_users)
        item_mask = np.arange(ni) < len(all_items)

        # numpy leaves: the device upload happens once, in SubgraphBatch.to
        return SubgraphBatch(
            user_ids=user_ids,
            item_ids=item_ids,
            user_mask=user_mask,
            item_mask=item_mask,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_mask=edge_mask,
            label_src=label_src,
            label_dst=label_dst,
            label=label,
            label_mask=label_mask,
            label_item_global=label_item_global,
            seed_users=seeds,
            seed_slots=seed_slots,
            gt_items=gt_items,
            gt_count=gt_count,
        )

    def _assemble_truncated(
        self, per_user, b: int, valid_rows: int
    ) -> SubgraphBatch:
        """Budget-overflow path: sorted-unique slot maps with explicit
        membership checks; anything touching a dropped node is invalidated
        (and counted in ``self.truncations``)."""
        bud = self.budgets
        l_max = bud.labels_per_user

        all_users = np.unique(
            np.concatenate(
                [np.asarray([p[0]], np.int64) for p in per_user]
                + [p[5] for p in per_user]
            )
        )[: bud.num_user_slots]
        all_items = np.unique(
            np.concatenate(
                [np.concatenate([p[1], p[4], p[6]]) for p in per_user]
            )
        )[: bud.num_item_slots] if per_user else np.empty(0, np.int64)

        def uslot(x):
            return np.searchsorted(all_users, x)

        def islot(x):
            return np.searchsorted(all_items, x)

        # subgraph edges = per-user (positive edges + hop edges), local coords
        esrc_l, edst_l = [], []
        for (u, positives, _d, _sp, _n, hop_src, hop_dst) in per_user:
            esrc_l.append(np.full(len(positives), u, np.int64))
            edst_l.append(positives)
            esrc_l.append(hop_src)
            edst_l.append(hop_dst)
        esrc = np.concatenate(esrc_l)
        edst = np.concatenate(edst_l)
        # drop edges touching truncated nodes
        keep = np.isin(esrc, all_users) & np.isin(edst, all_items)
        if not keep.all():
            self.truncations["edges"] += int((~keep).sum())
            esrc, edst = esrc[keep], edst[keep]
        if len(esrc) > bud.num_edges:
            self.truncations["edges"] += len(esrc) - bud.num_edges
            esrc, edst = esrc[: bud.num_edges], edst[: bud.num_edges]

        e_pad = bud.num_edges
        edge_src = np.zeros(e_pad, np.int32)
        edge_dst = np.zeros(e_pad, np.int32)
        edge_mask = np.zeros(e_pad, bool)
        edge_src[: len(esrc)] = uslot(esrc)
        edge_dst[: len(esrc)] = islot(edst)
        edge_mask[: len(esrc)] = True

        label_src = np.zeros((b, l_max), np.int32)
        label_dst = np.zeros((b, l_max), np.int32)
        label = np.zeros((b, l_max), np.float32)
        label_mask = np.zeros((b, l_max), bool)
        label_item_global = np.zeros((b, l_max), np.int32)
        gt_items = np.full((b, bud.gt_per_user), -1, np.int32)
        gt_count = np.zeros(b, np.int32)
        seeds = np.zeros(b, np.int32)
        seed_slots = np.zeros(b, np.int32)

        for row, (u, positives, _d, sampled_pos, negs, _hs, _hd) in enumerate(per_user):
            # a truncated node set invalidates any label whose endpoint
            # was dropped — sampled positives and the seed user included
            # (otherwise searchsorted would map them to a wrong slot
            # while the label stays set)
            negs = negs[np.isin(negs, all_items)]
            sampled_pos = sampled_pos[np.isin(sampled_pos, all_items)]
            if u not in all_users:
                gt_count[row] = 0
                seeds[row] = u
                continue
            items = np.concatenate([sampled_pos, negs])
            n_pos = len(sampled_pos)
            if len(items) > l_max:
                self.truncations["labels"] += len(items) - l_max
                items = items[:l_max]
                n_pos = min(n_pos, l_max)
            c = len(items)
            label[row, :n_pos] = 1.0
            label_mask[row, :c] = True
            label_item_global[row, :c] = items
            g = min(len(positives), bud.gt_per_user)
            gt_items[row, :g] = positives[:g]
            gt_count[row] = g
            seeds[row] = u

        seed_slots[:] = uslot(seeds)
        label_src[:] = np.where(label_mask, seed_slots[:, None], 0)
        label_dst[:] = np.where(label_mask, islot(label_item_global), 0)

        if valid_rows < b:
            label_mask[valid_rows:] = False
            gt_count[valid_rows:] = 0

        return self._pack(
            all_users, all_items, edge_src, edge_dst, edge_mask,
            label_src, label_dst, label, label_mask, label_item_global,
            seeds, seed_slots, gt_items, gt_count,
        )

    def epoch_user_chunks(self, shuffle: bool = True):
        """The epoch's (chunk, valid_rows) schedule without assembling
        batches — the shared work-list of both the serial and the parallel
        iterators."""
        users = np.arange(self.num_users)
        # skip users with no edges in this split (reference datasets only
        # index users present in the adjacency dict)
        users = users[self.users.degrees > 0]
        if shuffle and self.randomization:
            self.rng.shuffle(users)
        b = self.cfg.batch_size
        out = []
        for s in range(0, len(users), b):
            chunk = users[s : s + b]
            valid = len(chunk)
            if valid < b:
                chunk = np.concatenate([chunk, np.full(b - valid, chunk[-1])])
            out.append((chunk, valid))
        return out

    def epoch_batches(self, shuffle: bool = True):
        """Iterate the users in batches of ``cfg.batch_size`` (last partial
        batch is padded by repeating the final user, masked out via gt_count
        =0 semantics not needed — labels stay valid; mirrors DataLoader
        drop_last=False)."""
        for chunk, valid in self.epoch_user_chunks(shuffle):
            yield self.sample_batch(chunk, valid_rows=valid)

    def clone(self, seed: int) -> "SubgraphSampler":
        """A worker-owned view for parallel sampling: shares the (read-only)
        CSRs, matchers, config and budgets; owns its RNG and truncation
        counters. O(1) — no adjacency copies."""
        s = SubgraphSampler(
            self.cfg, self.users, self.items, self.train,
            matchers=self.matchers or None,
            randomization=self.randomization, seed=seed,
            budgets=self.budgets, use_native=self._native is not None,
        )
        return s


def parallel_epoch_batches(
    sampler: SubgraphSampler,
    num_workers: int = 2,
    shuffle: bool = True,
    buffer_per_worker: int = 2,
):
    """Multi-worker epoch iterator — the reference DataLoader's
    ``num_workers`` (``config.py:41``, ``data/data_loader.py:48-50``) as
    threads instead of fork+pickle: the native assembly path releases the
    GIL inside its C++ calls, so W workers genuinely overlap on W cores.

    Worker ``w`` owns ``sampler.clone(seed)`` and assembles every W-th batch
    of the epoch schedule; batches yield in epoch order. Negative draws and
    truncation counters come from the workers' own streams, so a parallel
    epoch is statistically equivalent to — not bitwise identical with — the
    serial one. Worker truncations are merged into ``sampler.truncations``
    as the epoch drains (the telemetry stays one counter)."""
    import queue as _queue
    import threading as _threading

    chunks = sampler.epoch_user_chunks(shuffle)
    n = len(chunks)
    if num_workers <= 1 or n <= 1:
        for chunk, valid in chunks:
            yield sampler.sample_batch(chunk, valid_rows=valid)
        return

    num_workers = min(num_workers, n)
    out_q: "_queue.Queue" = _queue.Queue(
        maxsize=max(1, buffer_per_worker) * num_workers
    )
    # fan the schedule out round-robin; reorder by index on the way out
    base = int(sampler.rng.integers(0, 2**31 - 1))
    workers = [sampler.clone(base + w) for w in range(num_workers)]
    stop = _threading.Event()

    def guarded_put(item) -> bool:
        # bounded put so an abandoned consumer (generator closed mid-epoch)
        # never leaves a worker blocked forever holding a batch
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def run(w: int):
        try:
            for i in range(w, n, num_workers):
                if stop.is_set():
                    return
                chunk, valid = chunks[i]
                if not guarded_put(
                    (i, workers[w].sample_batch(chunk, valid_rows=valid))
                ):
                    return
        except BaseException as e:  # propagate to the consumer
            guarded_put((-1, e))

    threads = [
        _threading.Thread(target=run, args=(w,), daemon=True)
        for w in range(num_workers)
    ]
    for t in threads:
        t.start()
    try:
        pending: dict = {}
        for want in range(n):
            while want not in pending:
                i, item = out_q.get()
                if i < 0:
                    raise item
                pending[i] = item
            yield pending.pop(want)
    finally:
        # runs on normal exhaustion AND on early abandonment (close/break):
        # cancel workers, drain so blocked puts unstick, then merge the
        # workers' truncation counters into the caller's single telemetry
        stop.set()
        for t in threads:
            while t.is_alive():
                try:
                    i, item = out_q.get_nowait()
                    if i < 0:
                        # a worker failed after the consumer started closing:
                        # don't swallow its exception — surface it (log only;
                        # raising from a finally would mask the original exit)
                        import logging

                        logging.getLogger(__name__).warning(
                            "sampler worker error during drain: %r", item
                        )
                except _queue.Empty:
                    pass
                t.join(timeout=0.05)
        for w in workers:
            for k, v in w.truncations.items():
                sampler.truncations[k] = sampler.truncations.get(k, 0) + v
