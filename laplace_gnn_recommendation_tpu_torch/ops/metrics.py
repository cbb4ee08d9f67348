"""Batched ranking metrics (counterpart of the JAX package's
``ops/metrics.py``, the part the LightGCN eval needs)."""
from __future__ import annotations

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
