"""Full-catalog top-k scoring (MIPS) with exclusion masking — counterpart of
the JAX package's ``ops/topk.py``, single device and sharded.

Exclusion semantics: excluded scores are set to ``EXCLUDE_FILL`` (the
reference's ``-(1 << 10)``) before one top-k, which equals taking
``topk(k + |excluded|)`` and dropping excluded ids.

Exclusions are written at fixed shapes: every one of the [B, X] slots is one
write into a flat buffer that holds the [B, I] scores and one spare element
past them, and a slot that excludes nothing (a negative id, an id past the
catalog, a slot at or past the row's count) writes the spare. Nothing waits
for the card to learn how many slots are valid, so a batch loop can issue
product, exclusion and top-k without a host round trip. A caller that
answers many batches may compute their positions once
(:func:`exclusion_slots` over a stack of batches) and hand each batch its
own as ``exclude_slots``. Where the scores are a temporary of the call
(``mips_topk``, ``mips_topk_int8``, ``sharded_mips_topk``, which record no
gradient) the product lands in such a buffer and the fill is written in
place; ``apply_exclusion`` and ``masked_topk`` copy the caller's scores into
one and leave them untouched.
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


def streams_f32(device_type: str, batch: int, num_items: int, dim: int, k: int) -> bool:
    """Whether a single-device f32 batch of ``batch`` users against
    ``num_items`` items at width ``dim`` is answered by kernel B with
    exclusion lists (``topk_pallas.streaming_mips_topk_lists``) rather than
    by :func:`mips_topk`: on a CUDA card, for batches up to
    ``STREAMING_MAX_BATCH``, ``k`` up to ``MAX_K`` and the catalog, where a
    block of kernel B fits the card's shared memory at (dim, k)."""
    from .topk_pallas import MAX_K, kernel_b_fits

    return (device_type == "cuda" and 1 <= batch <= STREAMING_MAX_BATCH
            and 1 <= k <= min(MAX_K, num_items) and kernel_b_fits(dim, k))


def sorted_exclusions(
    num_items: int,
    exclude_items: torch.Tensor,  # int [N, X], -1 pads
    exclude_count: Optional[torch.Tensor] = None,  # int [N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows int32 [N, X], counts int32 [N]): each row's valid ids (in the
    catalog, at a slot below its count) in ascending order in its first
    ``count`` slots, -1 after; the layout kernel B's list route reads. The
    same exclusions as the input in every helper of this module."""
    x = exclude_items.shape[1]
    dev = exclude_items.device
    valid = (exclude_items >= 0) & (exclude_items < num_items)
    if exclude_count is not None:
        valid &= torch.arange(x, device=dev) < exclude_count[:, None]
    big = torch.iinfo(torch.int32).max
    rows = torch.where(valid, exclude_items.to(torch.int32), big).sort(dim=1).values
    return (torch.where(rows == big, -1, rows).contiguous(),
            valid.sum(dim=1, dtype=torch.int32))


def exclusion_slots(
    num_cols: int,
    exclude_items: torch.Tensor,  # int [..., B, X], -1 pads
    exclude_count: Optional[torch.Tensor] = None,  # int [..., B]
    offset: int = 0,
) -> torch.Tensor:
    """Flat positions (int64 [..., B, X]) of the excluded entries in a
    row-major [B, num_cols] buffer whose ids start at ``offset``, one such
    buffer for each index of the leading dimensions: a valid slot (id −
    offset in [0, num_cols), slot below the row's count) gives row ·
    num_cols + id − offset; every other slot gives B · num_cols, the spare
    element past the matrix. Fixed shape; no host wait."""
    b, x = exclude_items.shape[-2:]
    dev = exclude_items.device
    local = exclude_items - offset if offset else exclude_items
    valid = (local >= 0) & (local < num_cols)
    if exclude_count is not None:
        valid &= torch.arange(x, device=dev) < exclude_count[..., None]
    # int64 row starts: the sum is int64 whatever the ids' integer type
    flat = torch.arange(0, b * num_cols, num_cols, device=dev)[:, None] + local
    return torch.where(valid, flat, b * num_cols)


def scores_with_spare(
    num_rows: int, num_cols: int, dtype=torch.float32, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat buffer of num_rows · num_cols + 1 elements, its contiguous
    [num_rows, num_cols] view): the matrix and the spare element that
    :func:`exclusion_slots` aims invalid slots at."""
    buf = torch.empty(num_rows * num_cols + 1, dtype=dtype, device=device)
    return buf, buf[: num_rows * num_cols].view(num_rows, num_cols)


def _exclude_(buf, num_cols, exclude_items, exclude_count, exclude_slots, fill, offset=0):
    """In place: ``fill`` at every excluded position of ``buf`` (a
    :func:`scores_with_spare` buffer): ``exclude_slots`` where given, else
    those of the items and counts; invalid slots write the spare."""
    if exclude_slots is None and exclude_items is not None:
        exclude_slots = exclusion_slots(num_cols, exclude_items, exclude_count, offset)
    if exclude_slots is not None:
        buf.index_fill_(0, exclude_slots.reshape(-1), fill)


def apply_exclusion(
    scores: torch.Tensor,         # [B, I]
    exclude_items: torch.Tensor,  # int [B, X], -1 pads
    exclude_count: Optional[torch.Tensor] = None,  # int [B]
    fill: float = EXCLUDE_FILL,
) -> torch.Tensor:
    """Copy of ``scores`` with ``scores[b, exclude_items[b, j]] = fill`` for
    valid j: non-negative, below the catalog size and, with
    ``exclude_count``, at a slot below the row's count. ``scores`` is left
    as it was."""
    b, num_items = scores.shape
    buf, out = scores_with_spare(b, num_items, scores.dtype, scores.device)
    out.copy_(scores)
    _exclude_(buf, num_items, exclude_items, exclude_count, None, fill)
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
    """top-k over the item axis after exclusion masking; the caller's
    ``scores`` are left as they were."""
    if exclude_items is not None:
        scores = apply_exclusion(scores, exclude_items, exclude_count)
    return hierarchical_topk(scores, k)


@torch.no_grad()
def mips_topk(
    user_emb: torch.Tensor,   # [B, D]
    item_emb: torch.Tensor,   # [I, D]
    k: int,
    exclude_items: Optional[torch.Tensor] = None,
    exclude_count: Optional[torch.Tensor] = None,
    exclude_slots: Optional[torch.Tensor] = None,   # [B, X], from exclusion_slots(I, ...)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materializing MIPS top-k: one [B, D]×[D, I] product into a buffer
    with a spare element, exclusions filled in place, one top-k."""
    b, num_items = user_emb.shape[0], item_emb.shape[0]
    buf, scores = scores_with_spare(b, num_items, device=user_emb.device)
    torch.mm(user_emb.float(), item_emb.float().T, out=scores)
    _exclude_(buf, num_items, exclude_items, exclude_count, exclude_slots, EXCLUDE_FILL)
    return hierarchical_topk(scores, k)


@torch.no_grad()
def mips_topk_int8(
    user_emb: torch.Tensor,      # f32 [B, D]
    q_items: torch.Tensor,       # int8 [I, D] (topk_pallas.row_quantize)
    item_scales: torch.Tensor,   # f32 [1, I]
    k: int,
    exclude_items: Optional[torch.Tensor] = None,
    exclude_count: Optional[torch.Tensor] = None,
    exclude_slots: Optional[torch.Tensor] = None,   # [B, X], from exclusion_slots(I, ...)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materializing retrieval over an int8 catalog: users row-quantized on
    the fly, exact integer scores dequantized as (raw · su) · si, masked
    top-k (exclusions filled in place, as in :func:`mips_topk`)."""
    from .topk_pallas import row_quantize

    qu, su = row_quantize(user_emb.float())
    raw = qu.to(torch.float64) @ q_items.to(torch.float64).T  # exact
    b, num_items = raw.shape
    buf, scores = scores_with_spare(b, num_items, device=raw.device)
    torch.mul(raw.to(torch.float32) * su.reshape(-1, 1), item_scales.reshape(1, -1), out=scores)
    _exclude_(buf, num_items, exclude_items, exclude_count, exclude_slots, EXCLUDE_FILL)
    return hierarchical_topk(scores, k)


def auto_mips_topk(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    k: int,
    exclude_items: Optional[torch.Tensor] = None,
    exclude_count: Optional[torch.Tensor] = None,
    exclude_slots: Optional[torch.Tensor] = None,   # [B, X], from exclusion_slots(I, ...)
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
        if exclude_items is not None or exclude_slots is not None:
            mask = exclusion_mask(num_items, exclude_items, exclude_count, exclude_slots)
        return streaming_mips_topk(user_emb, item_emb, k, mask)
    return mips_topk(user_emb, item_emb, k, exclude_items, exclude_count, exclude_slots)


@torch.no_grad()
def sharded_mips_topk(
    mesh,
    user_emb: torch.Tensor,   # [B, D], the same on every rank
    item_emb: torch.Tensor,   # [I/p, D], this rank's row block of the catalog
    k: int,
    exclude_items: Optional[torch.Tensor] = None,  # global ids [B, X]
    exclude_count: Optional[torch.Tensor] = None,  # [B]
    num_valid_items: Optional[int] = None,
    exclude_slots: Optional[torch.Tensor] = None,  # [B, X], exclusion_slots(I/p, ..., offset)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed MIPS top-k (JAX ``ops/topk.py:205-290``): on each rank of
    ``model`` one product with its catalog block, exclusions set to
    ``EXCLUDE_FILL``, columns at or past ``num_valid_items`` (the pad tail of
    a catalog padded to divide the axis) set to ``-inf``, and the block's
    top-k; then the k·p candidates are all-gathered and merged by one more
    top-k (ties to the lower candidate slot, as ``lax.top_k``). Ids of
    non-finite merged values are clamped to 0, so a row with fewer than k
    items left still answers ids inside the catalog. Every rank returns the
    same (values, int32 ids) [B, k]; on a 1-wide model axis this is
    ``mips_topk`` with the tail mask. The product and top-k are library
    calls, as the JAX package's are XLA ``dot`` and ``top_k``: exclusions
    must read ``EXCLUDE_FILL``, not the streaming kernel's ``-inf``, which
    would change which ids fill an over-excluded row."""
    from ..parallel.collectives import all_gather_dim0
    from ..parallel.mesh import MODEL_AXIS

    parts = mesh.size(MODEL_AXIS)
    shard_items = item_emb.shape[0]
    if k > shard_items * parts:
        raise ValueError(f"k={k} exceeds the catalog's {shard_items * parts} rows")
    offset = mesh.rank(MODEL_AXIS) * shard_items
    if num_valid_items is not None and num_valid_items >= shard_items * parts:
        num_valid_items = None
    b = user_emb.shape[0]
    buf, scores = scores_with_spare(b, shard_items, device=user_emb.device)
    torch.mm(user_emb.float(), item_emb.float().T, out=scores)
    if num_valid_items is not None:
        # the pad tail reads -inf, not EXCLUDE_FILL: user exclusions may fill a
        # row's top-k with EXCLUDE_FILL ties, and a pad id must never win one
        scores[:, max(num_valid_items - offset, 0):] = -torch.inf
    _exclude_(buf, shard_items, exclude_items, exclude_count, exclude_slots, EXCLUDE_FILL, offset)
    vals, idx = hierarchical_topk(scores, min(k, shard_items))
    idx = idx + offset
    if parts > 1:
        b, kk = vals.shape
        vals = all_gather_dim0(vals[None], mesh, MODEL_AXIS).permute(1, 0, 2).reshape(b, parts * kk)
        idx = all_gather_dim0(idx[None], mesh, MODEL_AXIS).permute(1, 0, 2).reshape(b, parts * kk)
    mvals, mpos = top_k_lowest_first(vals, k)
    midx = torch.gather(idx, 1, mpos)
    if num_valid_items is not None:
        midx = torch.where(torch.isfinite(mvals), midx, torch.zeros_like(midx))
    return mvals, midx.to(torch.int32)
