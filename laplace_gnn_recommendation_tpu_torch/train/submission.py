"""Kaggle submission writer (MAP@12 format) — the port of the JAX package's
``train/submission.py`` (reference ``run_submission.py:14-96``):
inference over the test split, ranking only candidate (label-0) edges per
user, top-k article ids, mapped back to raw ids, written as
``submission.csv`` with columns ``customer_id, prediction``.

``submission_pipeline``, which reads the ETL artifacts, comes with the
periphery slice.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..configs import Config
from ..data.link_pred_data import LinkPredData
from ..models import sage
from ..ops.topk import top_k_lowest_first


def make_predictions(
    cfg: Config, params, bn_state, data: LinkPredData, test_sampler,
) -> Dict[int, np.ndarray]:
    """Per-user top-k candidate article ids (global contiguous ids), -1
    where a user's candidates ran short. Positive-labeled edges are left out
    of the ranking (``run_submission.py:59-66`` keeps ``edge_label == 0``)."""
    uf, itf = data.user_features, data.item_features
    dev = uf.device

    @torch.no_grad()
    def predict(batch):
        scores = sage.infer(
            params, bn_state, batch, uf, itf, cfg,
            user_features_float=data.user_features_float,
            item_features_float=data.item_features_float,
        )
        scores = torch.where(batch.label == 0, scores, torch.full_like(scores, sage.INFER_PAD))
        _, pos = top_k_lowest_first(scores, min(cfg.k, scores.shape[1]))
        items = torch.gather(batch.label_item_global, 1, pos)
        valid = torch.gather(batch.label_mask & (batch.label == 0), 1, pos)
        return torch.where(valid, items, torch.full_like(items, -1))

    out: Dict[int, np.ndarray] = {}
    for batch in test_sampler.epoch_batches(shuffle=False):
        items = predict(batch.to(dev)).cpu().numpy().astype(np.int32)
        for row, u in enumerate(np.asarray(batch.seed_users)):
            # first write wins; padded last-batch rows repeat the final user
            if int(u) not in out:
                out[int(u)] = items[row]
    return out


def map_to_raw_ids(
    predictions: Dict[int, np.ndarray],
    customer_id_map_forward: Dict[str, object],
    article_id_map_forward: Dict[str, object],
) -> Tuple[list, list]:
    """Contiguous ids → raw dataset ids (reference ``run_submission.py:30-45``)."""
    customers, preds = [], []
    for u in sorted(predictions):
        raw_c = customer_id_map_forward[str(u)]
        raw_items = [
            str(article_id_map_forward[str(int(i))])
            for i in predictions[u]
            if int(i) >= 0
        ]
        customers.append(str(raw_c))
        preds.append(" ".join(raw_items))
    return customers, preds


def save_csv(path: str, customers: list, preds: list) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("customer_id,prediction\n")
        for c, p in zip(customers, preds):
            f.write(f"{c},{p}\n")
