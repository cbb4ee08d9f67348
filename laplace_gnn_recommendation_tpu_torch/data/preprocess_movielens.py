"""MovieLens-1M preprocessing: ``.dat`` files → graph artifacts — the port's
copy of the JAX package's ``data/preprocess_movielens.py``, so both packages
write identical artifacts from the same files.

Reproduces reference ``run_preprocessing.py:28-195`` exactly: `::`-delimited
parsing, genre one-hot expansion + year extraction from titles
(``:39-54``), label encoding of every feature column, unconnected-node
filtering, contiguous-id remap, chronological sort + per-user leave-last-2
split. Output goes through :mod:`.etl` (npz/json instead of pickled ``.pt``).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np

from ..constants import EDGE_KEY, NODE_ITEM, NODE_USER
from ..types import PreprocessingConfig
from .etl import (
    LinkPredArtifacts,
    create_ids_and_maps,
    encode_labels,
    filter_unconnected,
    save_artifacts,
)
from .graph import HeteroGraph
from .splitting import train_test_split_by_time


def _read_dat(path: str, n_fields: int) -> List[List[str]]:
    rows = []
    with open(path, encoding="latin1") as f:
        for line in f:
            parts = line.strip().split("::")
            if len(parts) >= n_fields:
                rows.append(parts[:n_fields])
    return rows


def parse_movies(path: str) -> Dict[str, np.ndarray]:
    """movies.dat → per-movie feature dict (title year + genre one-hots) —
    reference ``run_preprocessing.py:37-54``."""
    ids, years, genre_sets = [], [], []
    all_genres: List[str] = []
    for id_, title, genres in _read_dat(path, 3):
        gset = set(genres.split("|"))
        assert re.match(r".*\([0-9]{4}\)$", title), title
        years.append(title[-5:-1])
        ids.append(int(id_))
        genre_sets.append(gset)
        for g in gset:
            if g not in all_genres:
                all_genres.append(g)
    columns = {"article_id": np.array(ids, np.int64), "year": np.array(years)}
    for g in all_genres:
        columns[g] = np.array([1 if g in s else 0 for s in genre_sets], np.int64)
    return columns


def preprocess(
    config: PreprocessingConfig,
    raw_dir: str = "data/original",
    artifact_dir: str = "data/derived",
) -> LinkPredArtifacts:
    config.print()
    print("| Loading customers...")
    users_rows = _read_dat(os.path.join(raw_dir, "users.dat"), 5)
    customer_ids = np.array([int(r[0]) for r in users_rows], np.int64)
    customer_cols = {
        "gender": np.array([r[1] for r in users_rows]),
        "age": np.array([r[2] for r in users_rows]),
        "occupation": np.array([r[3] for r in users_rows]),
        "zip": np.array([r[4] for r in users_rows]),
    }

    print("| Loading articles...")
    movie_cols = parse_movies(os.path.join(raw_dir, "movies.dat"))
    article_ids = movie_cols.pop("article_id")

    print("| Loading transactions...")
    tx_rows = _read_dat(os.path.join(raw_dir, "ratings.dat"), 4)
    tx_customer = np.array([int(r[0]) for r in tx_rows], np.int64)
    tx_article = np.array([int(r[1]) for r in tx_rows], np.int64)
    tx_time = np.array([int(r[3]) for r in tx_rows], np.int64)
    if config.data_size is not None:
        tx_customer = tx_customer[: config.data_size]
        tx_article = tx_article[: config.data_size]
        tx_time = tx_time[: config.data_size]

    print("| Encoding features...")
    customer_feats = np.stack(
        [encode_labels(v) for v in customer_cols.values()], axis=1
    )
    article_feats = np.stack(
        [encode_labels(v) for v in movie_cols.values()], axis=1
    )

    if config.filter_out_unconnected_nodes:
        print("| Removing unconnected nodes...")
        keep_c = filter_unconnected(customer_ids, tx_customer)
        keep_a = filter_unconnected(article_ids, tx_article)
        print(f"|     Removing {int((~keep_c).sum())} customers...")
        print(f"|     Removing {int((~keep_a).sum())} articles...")
        customer_ids, customer_feats = customer_ids[keep_c], customer_feats[keep_c]
        article_ids, article_feats = article_ids[keep_a], article_feats[keep_a]

    c_fwd, c_rev = create_ids_and_maps(customer_ids)
    a_fwd, a_rev = create_ids_and_maps(article_ids)

    print("| Parsing transactions...")
    tx_c = np.array([c_rev[x] for x in tx_customer], np.int64)
    tx_a = np.array([a_rev[x] for x in tx_article], np.int64)

    print("| Chronological split...")
    order = np.argsort(tx_time, kind="stable")
    tx_c, tx_a = tx_c[order], tx_a[order]
    train_mask, val_mask, test_mask = train_test_split_by_time(tx_c)

    graph = HeteroGraph(
        node_features={NODE_USER: customer_feats.astype(np.int32),
                       NODE_ITEM: article_feats.astype(np.int32)},
        edges={EDGE_KEY: (tx_c, tx_a)},
        num_nodes={NODE_USER: len(customer_ids), NODE_ITEM: len(article_ids)},
    )
    artifacts = LinkPredArtifacts(
        graph=graph,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        customer_id_map_forward=c_fwd,
        article_id_map_forward=a_fwd,
    )
    print("| Saving artifacts...")
    save_artifacts(artifact_dir, artifacts)
    return artifacts
