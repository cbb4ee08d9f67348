"""Kaggle submission writer (MAP@12 format) — the port of the JAX package's
``train/submission.py`` (reference ``run_submission.py:14-96``):
inference over the test split, ranking only candidate (label-0) edges per
user, top-k article ids, mapped back to raw ids, written as
``submission.csv`` with columns ``customer_id, prediction``;
``submission_pipeline`` loads the newest checkpoint or takes the params it
is given.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import Config
from ..data.link_pred_data import LinkPredData, create_samplers
from ..models import sage
from ..ops.topk import top_k_lowest_first
from .checkpoint import load_latest


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


def submission_pipeline(
    cfg: Config,
    data: LinkPredData,
    customer_id_map_forward: Dict[str, object],
    article_id_map_forward: Dict[str, object],
    model_dir: str = "model/saved",
    out_path: str = "data/derived/submission.csv",
    params_bn: Optional[Tuple] = None,
    mesh=None,
) -> str:
    """The whole submission flow (reference ``run_submission.py:78-92``) on the
    device of ``data``'s tables. ``params_bn=(params, bn_state)`` skips the
    checkpoint (right after training in the same process); otherwise the
    newest ``model_dir/model_<n>.npz`` is loaded, one the JAX pipeline wrote
    too. Returns the CSV's path."""
    if mesh is not None:
        raise NotImplementedError("a multi-device mesh comes with the multi-GPU slice")
    if params_bn is None:
        print("| Loading Model...")
        params, bn_state = sage.init_sage_params(
            cfg, sage.get_feature_info(data.graph), float_dims=data.float_dims(),
            num_extra=data.num_extra, device=data.device,
        )
        state, ver = load_latest(model_dir, {"params": sage.jax_tree(params),
                                             "bn_state": bn_state})
        if ver is None:
            raise FileNotFoundError(f"no checkpoint under {model_dir}")
        sage.load_jax_tree_(params, state["params"])
        bn_state = state["bn_state"]
    else:
        params, bn_state = params_bn

    print("| Building test sampler...")
    _, _, test_sampler = create_samplers(cfg, data)

    print("| Making Predictions...")
    preds = make_predictions(cfg, params, bn_state, data, test_sampler)

    print("| Mapping to raw ids...")
    customers, pred_strs = map_to_raw_ids(preds, customer_id_map_forward, article_id_map_forward)

    print("| Saving predictions...")
    save_csv(out_path, customers, pred_strs)
    return out_path
