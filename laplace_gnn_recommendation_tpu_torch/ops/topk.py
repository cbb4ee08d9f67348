"""Full-catalog top-k scoring (MIPS) with exclusion masking — counterpart of
the JAX package's ``ops/topk.py`` (single device; the sharded form comes
with the multi-GPU slice).

Exclusion semantics: excluded scores are set to ``EXCLUDE_FILL`` (the
reference's ``-(1 << 10)``) before one top-k, which equals taking
``topk(k + |excluded|)`` and dropping excluded ids.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

EXCLUDE_FILL = -(1 << 10)  # reference utils/metrics_encoder_decoder.py:69

# Dispatch thresholds of ``auto_mips_topk``, kept from the JAX package: the
# streaming kernel serves when the [B, I] f32 score matrix would pass
# SCORES_BYTES_BUDGET, for batches up to STREAMING_MAX_BATCH.
SCORES_BYTES_BUDGET = 512 << 20
STREAMING_MAX_BATCH = 512
STREAMING_TILE = 512


def apply_exclusion(
    scores: torch.Tensor,         # [B, I]
    exclude_items: torch.Tensor,  # int [B, X], -1 pads
    exclude_count: Optional[torch.Tensor] = None,  # int [B]
    fill: float = EXCLUDE_FILL,
) -> torch.Tensor:
    """Copy of ``scores`` with ``scores[b, exclude_items[b, j]] = fill`` for
    valid j: non-negative, below the catalog size and, with
    ``exclude_count``, at a slot below the row's count."""
    b, num_items = scores.shape
    x = exclude_items.shape[1]
    valid = (exclude_items >= 0) & (exclude_items < num_items)
    if exclude_count is not None:
        valid &= torch.arange(x, device=scores.device)[None, :] < exclude_count[:, None]
    rows = torch.arange(b, device=scores.device)[:, None].expand(b, x)
    out = scores.clone()
    out[rows[valid], exclude_items[valid].long()] = fill
    return out


def hierarchical_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis: (values, int32 ids). The JAX
    two-stage group reduction returns the same values as one ``top_k``;
    here that one call is ``torch.topk`` (ids may differ among ties)."""
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)


def top_k_lowest_first(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, ties in
    ascending index order — ``jax.lax.top_k``'s order, which ``torch.topk``
    does not promise on the card. A stable descending sort of the row; for
    the ranking stack's short label rows (tens to hundreds of slots)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_topk(
    scores: torch.Tensor,
    k: int,
    exclude_items: Optional[torch.Tensor] = None,
    exclude_count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """top-k over the item axis after exclusion masking."""
    if exclude_items is not None:
        scores = apply_exclusion(scores, exclude_items, exclude_count)
    return hierarchical_topk(scores, k)


def mips_topk(
    user_emb: torch.Tensor,   # [B, D]
    item_emb: torch.Tensor,   # [I, D]
    k: int,
    exclude_items: Optional[torch.Tensor] = None,
    exclude_count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materializing MIPS top-k: one [B, D]×[D, I] product + masked top-k."""
    scores = user_emb.float() @ item_emb.float().T
    return masked_topk(scores, k, exclude_items, exclude_count)


def mips_topk_int8(
    user_emb: torch.Tensor,      # f32 [B, D]
    q_items: torch.Tensor,       # int8 [I, D] (topk_pallas.row_quantize)
    item_scales: torch.Tensor,   # f32 [1, I]
    k: int,
    exclude_items: Optional[torch.Tensor] = None,
    exclude_count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materializing retrieval over an int8 catalog: users row-quantized on
    the fly, exact integer scores dequantized as (raw · su) · si, masked
    top-k."""
    from .topk_pallas import row_quantize

    qu, su = row_quantize(user_emb.float())
    raw = qu.to(torch.float64) @ q_items.to(torch.float64).T  # exact
    scores = raw.to(torch.float32) * su.reshape(-1, 1) * item_scales.reshape(1, -1)
    return masked_topk(scores, k, exclude_items, exclude_count)


def auto_mips_topk(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    k: int,
    exclude_items: Optional[torch.Tensor] = None,
    exclude_count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retrieval entry point: the materializing path by default; the
    streaming kernel (kernel B) on the card when the [B, I] f32 scores would
    exceed ``SCORES_BYTES_BUDGET`` (the JAX rule, with the card in place of
    the TPU: on the CPU the same rule picks the materializing path)."""
    num_items = item_emb.shape[0]
    b = user_emb.shape[0]
    if (
        user_emb.device.type == "cuda"
        and num_items % STREAMING_TILE == 0
        and b <= STREAMING_MAX_BATCH
        and b * num_items * 4 > SCORES_BYTES_BUDGET
    ):
        from .topk_pallas import exclusion_mask, streaming_mips_topk

        mask = None
        if exclude_items is not None:
            mask = exclusion_mask(num_items, exclude_items, exclude_count)
        return streaming_mips_topk(user_emb, item_emb, k, mask)
    return mips_topk(user_emb, item_emb, k, exclude_items, exclude_count)
