"""Batched ranking metrics: recall/precision/NDCG/MAP @k (the port of the
JAX package's ``ops/metrics.py``; reference ``utils/metrics.py:6-57``).

Ragged per-user ground truth arrives as a padded [B, G] matrix + count
vector; users with empty ground truth are left out through ``user_mask``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def topk_hits(
    topk_items: torch.Tensor,  # int [B, k]
    gt_items: torch.Tensor,    # int [B, G] padded
    gt_count: torch.Tensor,    # int [B]
) -> torch.Tensor:
    """Boolean hit matrix r[b, j] = topk_items[b, j] ∈ gt_items[b, :gt_count[b]]."""
    gt_mask = (
        torch.arange(gt_items.shape[1], device=gt_items.device)[None, :]
        < gt_count[:, None]
    )
    eq = topk_items.long()[:, :, None] == gt_items.long()[:, None, :]
    return (eq & gt_mask[:, None, :]).any(dim=-1)


def recall_precision_at_k(
    r: torch.Tensor,          # bool [B, k] hit matrix
    gt_count: torch.Tensor,   # int [B]
    k: int,
    user_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """recall = mean_u(hits_u / |gt_u|), precision = mean_u(hits_u) / k over
    the users of ``user_mask`` (default: a non-empty ground truth)."""
    if user_mask is None:
        user_mask = gt_count > 0
    denom = torch.clamp_min(user_mask.sum(), 1)
    hits = r.sum(dim=-1).float()
    recall_per_user = hits / torch.clamp_min(gt_count.float(), 1.0)
    zero = torch.zeros((), device=r.device)
    recall = torch.where(user_mask, recall_per_user, zero).sum() / denom
    precision = torch.where(user_mask, hits, zero).sum() / denom / k
    return recall, precision


def ndcg_at_k(
    r: torch.Tensor,
    gt_count: torch.Tensor,
    k: int,
    user_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mean_u(DCG_u / IDCG_u), the ideal over min(|gt_u|, k) slots, 0/0 → 0."""
    if user_mask is None:
        user_mask = gt_count > 0
    dev = r.device
    denom = torch.clamp_min(user_mask.sum(), 1)
    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32, device=dev))
    dcg = (r.float() * discounts[None, :]).sum(dim=-1)
    ideal_mask = torch.arange(k, device=dev)[None, :] < torch.clamp_max(gt_count, k)[:, None]
    idcg = (ideal_mask.float() * discounts[None, :]).sum(dim=-1)
    ndcg = dcg / torch.where(idcg == 0.0, torch.ones_like(idcg), idcg)
    return torch.where(user_mask, ndcg, torch.zeros((), device=dev)).sum() / denom


def map_at_k(
    r: torch.Tensor,
    gt_count: torch.Tensor,
    k: int,
    user_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean Average Precision @k (the Kaggle H&M leaderboard metric)."""
    if user_mask is None:
        user_mask = gt_count > 0
    dev = r.device
    denom = torch.clamp_min(user_mask.sum(), 1)
    rf = r.float()
    prec_at_i = rf.cumsum(dim=-1) / torch.arange(1, k + 1, dtype=torch.float32, device=dev)[None, :]
    ap = (prec_at_i * rf).sum(dim=-1) / torch.clamp_min(torch.clamp_max(gt_count, k).float(), 1.0)
    return torch.where(user_mask, ap, torch.zeros((), device=dev)).sum() / denom


def ranking_metrics(
    topk_items: torch.Tensor,
    gt_items: torch.Tensor,
    gt_count: torch.Tensor,
    k: int,
    user_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(recall, precision, ndcg) @k from a top-k id matrix."""
    r = topk_hits(topk_items, gt_items, gt_count)
    recall, precision = recall_precision_at_k(r, gt_count, k, user_mask)
    return recall, precision, ndcg_at_k(r, gt_count, k, user_mask)
