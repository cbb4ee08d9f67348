"""Candidate-generation matchers — the port of the JAX package's
``data/matchers.py`` (reference ``data/matching/``), numpy on the host.

Each matcher returns top-k candidate item ids for a user from precomputed
artifacts (CSR adjacencies / npz arrays). The registry mirrors
``data/matching/__init__.py:9-24`` (movielens → common-items; fashion →
popular-items + common-items, with lightgcn and same-location available).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .graph import HostCSR


class Matcher:
    """Abstract candidate generator (reference ``data/matching/type.py:5-10``)."""

    def get_matches(self, user_id: int) -> np.ndarray:
        raise NotImplementedError

    def get_matches_batch(self, user_ids: np.ndarray) -> np.ndarray:
        """Candidates for a whole batch as one padded [B, W] matrix (-1
        pads). Base implementation loops :meth:`get_matches`; subclasses
        override with vectorized/native paths — this is what lets eval
        batch assembly run in one C++ call (``native.assemble_train_batch``
        with ``eval_cands``) instead of per-user Python."""
        rows = [
            np.asarray(self.get_matches(int(u)), np.int64).ravel()
            for u in user_ids
        ]
        w = max((len(r) for r in rows), default=0) or 1
        out = np.full((len(rows), w), -1, np.int64)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out


class LightGCNMatcher(Matcher):
    """Top-k from the LightGCN artifact (reference ``data/matching/
    lightgcn.py:5-11``; artifact written by
    ``train/lightgcn_pipeline.export_artifacts``)."""

    def __init__(self, k: int, artifact_path: str = "data/derived/lightgcn_output.npz"):
        self.top_articles_per_user = np.load(artifact_path)["recommendations"]
        self.k = k

    def get_matches(self, user_id: int) -> np.ndarray:
        return self.top_articles_per_user[user_id][: self.k]

    def get_matches_batch(self, user_ids: np.ndarray) -> np.ndarray:
        return self.top_articles_per_user[np.asarray(user_ids)][:, : self.k]


class PopularItemsMatcher(Matcher):
    """Most-popular items, same list for every user (reference
    ``data/matching/fashion/popular_items.py:6-14``)."""

    def __init__(self, k: int, popular_items: np.ndarray):
        self.popular_items = np.asarray(popular_items, np.int64)
        self.k = k

    def get_matches(self, user_id: int) -> np.ndarray:
        return self.popular_items[: self.k]

    def get_matches_batch(self, user_ids: np.ndarray) -> np.ndarray:
        return np.broadcast_to(
            self.popular_items[: self.k], (len(user_ids), min(self.k, len(self.popular_items)))
        )


class UsersWithCommonItemsMatcher(Matcher):
    """Collaborative 2-hop: items purchased by users sharing an item with
    this user, first k in traversal order (reference
    ``data/matching/users_with_common_purchases.py:8-26``)."""

    def __init__(self, k: int, user_csr: HostCSR, item_csr: HostCSR):
        self.users = user_csr
        self.items = item_csr
        self.k = k

    def get_matches(self, user_id: int) -> np.ndarray:
        articles = self.users.neighbors(user_id)
        if len(articles) == 0:
            return np.empty(0, np.int64)
        # early-break once k candidates are collected: identical to the
        # reference's concat-then-[:k] (same traversal order) but O(k·deg)
        # instead of O(Σ deg²) — one popular article otherwise pulls every
        # co-purchaser's full history into memory per call
        out: list = []
        for a in articles:
            for u in self.items.neighbors(int(a)):
                items = self.users.neighbors(int(u))
                take = min(len(items), self.k - len(out))
                out.extend(int(x) for x in items[:take])
                if len(out) >= self.k:
                    return np.array(out[: self.k], np.int64)
        return np.array(out, np.int64)

    def get_matches_batch(self, user_ids: np.ndarray) -> np.ndarray:
        """One OpenMP-parallel native call for the whole batch (identical
        traversal order; ``native.common_items_matches``)."""
        from .. import native

        if not native.available():
            return super().get_matches_batch(user_ids)
        return native.common_items_matches(
            self.users.row_ptr, self.users.cols,
            self.items.row_ptr, self.items.cols,
            np.asarray(user_ids, np.int32), self.k,
        ).astype(np.int64)


class UsersSameLocationMatcher(Matcher):
    """Items purchased by users sharing the seed user's location (reference
    ``data/matching/fashion/users_same_location.py:8-25``)."""

    def __init__(
        self,
        k: int,
        location_for_user: np.ndarray,   # int [U]
        users_per_location: dict,         # location -> list of user ids
        user_csr: HostCSR,
    ):
        self.k = k
        self.location_for_user = location_for_user
        self.users_per_location = users_per_location
        self.users = user_csr

    def get_matches(self, user_id: int) -> np.ndarray:
        loc = int(self.location_for_user[user_id])
        peers = self.users_per_location.get(loc, [])
        if not peers:
            return np.empty(0, np.int64)
        items = [self.users.neighbors(int(u)) for u in peers]
        cat = np.concatenate(items) if items else np.empty(0, np.int64)
        return cat[: self.k]


def get_matchers(
    dataset_type: str,
    candidate_pool_size: int,
    user_csr: HostCSR,
    item_csr: HostCSR,
    popular_items: Optional[np.ndarray] = None,
    lightgcn_artifact: Optional[str] = None,
) -> List[Matcher]:
    """Strategy registry (reference ``data/matching/__init__.py:9-24``)."""
    if dataset_type == "movielens":
        return [UsersWithCommonItemsMatcher(candidate_pool_size, user_csr, item_csr)]
    if dataset_type == "fashion":
        matchers: List[Matcher] = []
        if lightgcn_artifact and os.path.exists(lightgcn_artifact):
            matchers.append(LightGCNMatcher(candidate_pool_size, lightgcn_artifact))
        if popular_items is not None:
            matchers.append(PopularItemsMatcher(candidate_pool_size, popular_items))
        matchers.append(
            UsersWithCommonItemsMatcher(candidate_pool_size, user_csr, item_csr)
        )
        return matchers
    raise ValueError(f"Unknown matchers type: {dataset_type}")
