"""H&M fashion preprocessing: parquet tables → graph artifacts — the port's
copy of the JAX package's ``data/preprocess_fashion.py``, so both packages
write identical artifacts from the same files.

Reproduces reference ``run_preprocessing_fashion.py:22-274``: feature-column
selection, average price per article (``:40-44``), label encoding of
categorical columns, unconnected-node filtering, contiguous-id remap,
optional extra node type (colour group) with ``has_color`` edges
(``:86-112``), optional CLIP image/text embedding concat (``:129-162``, the
npz files :func:`.clip_embed.produce_article_embeddings` writes),
users-per-location exports (``:164-168``) and the most popular products of
the last month, top 1,000 (``:170-177``). Transactions are deduplicated and
split by :func:`split_transactions` unless ``transactions_splitted.parquet``
is there. Host code: pandas (with a parquet engine) is imported when a
function runs.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..constants import EDGE_KEY, EDGE_KEY_EXTRA, NODE_EXTRA, NODE_ITEM, NODE_USER
from ..types import ArticleColumn, PreprocessingConfig, UserColumn
from .etl import (
    LinkPredArtifacts,
    create_ids_and_maps,
    encode_labels,
    filter_unconnected,
    save_artifacts,
)
from .graph import HeteroGraph
from .splitting import deduplicate_interactions, train_test_split_by_time


def split_transactions(tx) -> "pandas.DataFrame":
    """Dedup + chronological split of the raw transactions table — reference
    ``run_data_splitting.py:6-30`` (``split_data``)."""
    keep = deduplicate_interactions(
        encode_labels(tx["customer_id"].to_numpy()),
        encode_labels(tx["article_id"].to_numpy()),
    )
    tx = tx.iloc[keep].reset_index(drop=True)
    tr, va, te = train_test_split_by_time(tx["customer_id"].to_numpy())
    tx = tx.assign(train_mask=tr, val_mask=va, test_mask=te)
    return tx


def preprocess(
    config: PreprocessingConfig,
    raw_dir: str = "data/original",
    artifact_dir: str = "data/derived",
    include_extra_nodes: bool = False,
) -> LinkPredArtifacts:
    import pandas as pd

    config.print()
    print("| Loading customers...")
    customers = pd.read_parquet(os.path.join(raw_dir, "customers.parquet")).fillna(0.0)
    customer_cols = [c.value for c in config.customer_features]
    customers = customers[customer_cols + ["customer_id"]]

    print("| Loading articles...")
    articles = pd.read_parquet(os.path.join(raw_dir, "articles.parquet")).fillna(0.0)

    print("| Loading transactions...")
    tx_path = os.path.join(raw_dir, "transactions_splitted.parquet")
    if os.path.exists(tx_path):
        transactions = pd.read_parquet(tx_path)
    else:
        transactions = split_transactions(
            pd.read_parquet(os.path.join(raw_dir, "transactions_train.parquet"))
        )
    if config.data_size is not None:
        transactions = transactions[: config.data_size]

    print("| Calculating average price per product...")
    avg_price = transactions.groupby("article_id")["price"].mean()
    articles = articles.merge(
        avg_price.rename("avg_price"), on="article_id", how="outer"
    ).fillna(0.0)
    article_cols = [c.value for c in config.article_features]
    noncat = {c.value for c in config.article_non_categorical_features}
    articles = articles[[c for c in article_cols if c in articles.columns] + ["article_id"]]

    print("| Encoding features...")
    for col in articles.columns:
        if col not in noncat and col != "article_id":
            articles[col] = encode_labels(articles[col].to_numpy())
    for col in customers.columns:
        if col != "customer_id":
            customers[col] = encode_labels(customers[col].to_numpy())

    if config.filter_out_unconnected_nodes:
        print("| Removing unconnected nodes...")
        keep_c = filter_unconnected(
            customers["customer_id"].to_numpy(), transactions["customer_id"].to_numpy()
        )
        keep_a = filter_unconnected(
            articles["article_id"].to_numpy(), transactions["article_id"].to_numpy()
        )
        print(f"|     Removing {int((~keep_c).sum())} customers...")
        print(f"|     Removing {int((~keep_a).sum())} articles...")
        customers = customers[keep_c].reset_index(drop=True)
        articles = articles[keep_a].reset_index(drop=True)

    c_fwd, c_rev = create_ids_and_maps(customers["customer_id"].to_numpy())
    a_fwd, a_rev = create_ids_and_maps(articles["article_id"].to_numpy())

    print("| Parsing transactions...")
    tx_c = transactions["customer_id"].map(c_rev).to_numpy(np.int64)
    tx_a = transactions["article_id"].map(a_rev).to_numpy(np.int64)
    train_mask = transactions["train_mask"].to_numpy(bool)
    val_mask = transactions["val_mask"].to_numpy(bool)
    test_mask = transactions["test_mask"].to_numpy(bool)

    print("| Calculating the most popular products of the last month...")
    month = pd.to_datetime(transactions["t_dat"]).dt.strftime("%Y-%m").to_numpy()
    last_month = month[-1]
    last_tx_a = tx_a[month == last_month]
    counts = np.bincount(last_tx_a, minlength=len(a_fwd))
    popular_items = np.argsort(-counts, kind="stable")[:1000]

    print("| Exporting per-location info...")
    location_for_user = customers[UserColumn.PostalCode.value].to_numpy(np.int64)

    feature_cols = [c for c in customers.columns if c != "customer_id"]
    customer_feats = customers[feature_cols].to_numpy(np.int64)
    article_feature_cols = [
        c for c in articles.columns if c != "article_id" and c not in noncat
    ]
    article_feats = articles[article_feature_cols].to_numpy(np.int64)

    node_features = {
        NODE_USER: customer_feats.astype(np.int32),
        NODE_ITEM: article_feats.astype(np.int32),
    }
    edges = {EDGE_KEY: (tx_c, tx_a)}
    num_nodes = {NODE_USER: len(c_fwd), NODE_ITEM: len(a_fwd)}

    node_features_float: Dict[str, np.ndarray] = {}
    for flag, fname in (
        (config.load_image_embedding, "image_embeddings.npz"),
        (config.load_text_embedding, "text_embeddings.npz"),
    ):
        # CLIP ViT-B/32 512-d embeddings (reference :129-162); artifact is an
        # npz keyed by raw article id → vector
        if flag:
            path = os.path.join(raw_dir, fname)
            z = np.load(path)
            dim = int(z[z.files[0]].shape[-1]) if z.files else 512
            mat = np.zeros((len(a_fwd), dim), np.float32)
            for new_id, raw in a_fwd.items():
                key = str(raw)
                if key in z.files:
                    mat[new_id] = z[key]
            prev = node_features_float.get(NODE_ITEM)
            node_features_float[NODE_ITEM] = (
                mat if prev is None else np.concatenate([prev, mat], axis=1)
            )

    if include_extra_nodes:
        print("| Building extra colour-group node type...")
        colour = articles[ArticleColumn.ColourGroupCode.value].to_numpy(np.int64)
        uniq = np.unique(colour)
        colour_rev = {int(c): i for i, c in enumerate(uniq)}
        extra_ids = np.array([colour_rev[int(c)] for c in colour], np.int64)
        node_features[NODE_EXTRA] = uniq[:, None].astype(np.int32)
        edges[EDGE_KEY_EXTRA] = (np.arange(len(colour), dtype=np.int64), extra_ids)
        num_nodes[NODE_EXTRA] = len(uniq)

    graph = HeteroGraph(
        node_features=node_features,
        edges=edges,
        num_nodes=num_nodes,
        node_features_float=node_features_float,
    )
    artifacts = LinkPredArtifacts(
        graph=graph,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        customer_id_map_forward=c_fwd,
        article_id_map_forward=a_fwd,
        popular_items=popular_items,
        location_for_user=location_for_user,
    )
    print("| Saving artifacts...")
    save_artifacts(artifact_dir, artifacts)
    return artifacts
