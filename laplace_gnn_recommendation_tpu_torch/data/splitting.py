"""Train/val/test splitting (numpy; a copy of the JAX package's
``data/splitting.py``, so splits are identical for the same seed).

Two strategies, matching the reference:

* :func:`train_test_split_by_time` — per-user leave-last-2-out chronological
  split (reference ``run_data_splitting.py:36-52``): for every user the last
  transaction goes to test, the second-to-last to val, the rest to train.
  The reference does this with a pandas groupby-apply (quadratic-ish Python);
  here it is a vectorized numpy rank computation.
* :func:`random_edge_split` — seeded random 80/10/10 edge split used by the
  LightGCN stack (reference ``data/lightgcn_loader.py:13-31``).

Both operate on plain arrays so they work for MovieLens and H&M alike.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def deduplicate_interactions(
    user_idx: np.ndarray, item_idx: np.ndarray
) -> np.ndarray:
    """Indices of first occurrences of each (user, item) pair, preserving
    order — reference ``run_data_splitting.py:20-30`` (keep="first")."""
    pairs = np.stack([user_idx, item_idx], axis=1)
    _, first_idx = np.unique(pairs, axis=0, return_index=True)
    return np.sort(first_idx)


def train_test_split_by_time(
    user_idx: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Boolean (train_mask, val_mask, test_mask) over rows assumed sorted by
    time (the reference sorts by timestamp first, ``run_preprocessing.py:112``).

    Per user with n rows: last row → test (if n > 1), second-to-last → val
    (if n > 2), rest → train. Exactly the semantics of
    ``run_data_splitting.py:42-49``.
    """
    user_idx = np.asarray(user_idx)
    n = len(user_idx)
    # rank-from-end of each row within its user's chronological sequence
    order = np.argsort(user_idx, kind="stable")  # stable keeps time order
    sorted_users = user_idx[order]
    # position within group
    group_start = np.r_[True, sorted_users[1:] != sorted_users[:-1]]
    group_id = np.cumsum(group_start) - 1
    counts = np.bincount(group_id)
    pos_in_group = np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts)
    size_of_group = np.repeat(counts, counts)
    from_end = size_of_group - 1 - pos_in_group  # 0 == last

    test_s = (from_end == 0) & (size_of_group > 1)
    val_s = (from_end == 1) & (size_of_group > 2)
    train_s = ~(test_s | val_s)

    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[order] = train_s
    val_mask[order] = val_s
    test_mask[order] = test_s
    return train_mask, val_mask, test_mask


def random_edge_split(
    num_edges: int, seed: int = 1, val_frac: float = 0.1, test_frac: float = 0.1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded random edge-index split: (train_idx, val_idx, test_idx).

    Reference ``data/lightgcn_loader.py:13-31``: sklearn train_test_split with
    random_state=1, 80/20 then 50/50 of the holdout.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_edges)
    n_hold = int(round(num_edges * (val_frac + test_frac)))
    n_val = n_hold // 2
    hold = perm[:n_hold]
    train_idx = perm[n_hold:]
    val_idx = hold[:n_val]
    test_idx = hold[n_val:]
    return np.sort(train_idx), np.sort(val_idx), np.sort(test_idx)
