"""Streaming MIPS top-k — the port of the JAX package's ``ops/topk_pallas.py``.

Kernel B (``csrc/topk_f32.cu``) replaces the Pallas kernels ``_kernel`` and
``_kernel_masked``; kernel C (``csrc/topk.cu``, ``topk_int8_launch``)
replaces ``_kernel_int8`` and ``_kernel_int8_masked``. Each takes an
optional int8 exclusion mask. The [B, I] score matrix never reaches device
memory: item tiles are staged in shared memory and folded into a running
k-best list per user; the catalog is cut into ranges that blocks fold in
parallel (each kernel's C-side plan sizes them from its occupancy), and a
merge pass combines each user's lists. Both share that fold
(``csrc/topk_fold.cuh``). Kernel B reads rows as float4 vectors, so its
wrapper hands it widths that are a multiple of 4 on 16-byte aligned
tensors: other widths are copied into fresh zero-padded tables
(:func:`pad_columns`; a zero column adds exactly 0 to every score); rows
too wide for two staged tiles are staged in column chunks inside the
kernel. Kernel C takes any width. Each stages item tiles of 128 rows.

Semantics (those of the Pallas fold ``_fold_topk``): the k best items by
(score descending, item id ascending); slots no item fills hold
(``NEG_INF``, id 0); excluded items score ``NEG_INF`` and never displace an
unfilled slot. ``k`` is at most ``MAX_K``.

Kernel B also takes exclusions as sorted per-user lists
(:func:`streaming_mips_topk_lists`): an [B, X] int32 table whose row holds
its user's excluded ids in ascending order in its first ``count`` slots
(``ops/topk.sorted_exclusions`` makes one). No [B, I] mask is built or read.
An excluded item there scores ``fill`` (``EXCLUDE_FILL``) and stays a
candidate, as in the materializing path, so a row with fewer than k
eligible items answers its excluded items at ``fill``, lowest ids first.

Every wrapper launches its kernel for tensors on the card and runs the
plain version (``*_plain``: full scores, stable sort) for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from .topk import EXCLUDE_FILL, apply_exclusion, exclusion_slots

NEG_INF = float(np.finfo(np.float32).min)
MAX_K = 256
_MAX_SMEM_BYTES = 232_448

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "topk_int8_launch": [_P] * 5 + [_I64] * 6 + [_P] * 5,
    "topk_int8_plan": [_I64] * 4 + [_P],
    "topk_smem_bytes": [_I64, _I64],
}
_F32_SIGNATURES = {
    "topk_f32_launch": [_P, _P, _P] + [_I64] * 6 + [_P] * 5,
    "topk_f32_lists_launch": [_P] * 4 + [_I64, ctypes.c_float] + [_I64] * 6 + [_P] * 5,
    "topk_f32_plan": [_I64] * 4 + [_P],
    "topk_f32_smem_bytes": [_I64, _I64],
}
# per kernel: (library, its signatures, its shared-memory and plan entry points)
_KERNELS = {
    "topk_int8": ("topk", _SIGNATURES, "topk_smem_bytes", "topk_int8_plan"),
    "topk_f32": ("topk_f32", _F32_SIGNATURES, "topk_f32_smem_bytes", "topk_f32_plan"),
}


def topk_fold_plain(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold's result from a full [B, I] score matrix: k best by (score
    desc, id asc), ``NEG_INF``-scored items replaced by (NEG_INF, 0)."""
    b, i = scores.shape
    if i < k:
        scores = torch.cat(
            [scores, scores.new_full((b, k - i), NEG_INF)], dim=1
        )
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    filled = vals > NEG_INF
    return (
        torch.where(filled, vals, torch.full_like(vals, NEG_INF)),
        torch.where(filled, idx, torch.zeros_like(idx)).to(torch.int32),
    )


def row_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: (q int8 [N, D], scales f32
    [1, N]) with x ≈ q · scalesᵀ; zero rows get scale 0. ``torch.round``
    rounds half to even, like ``jnp.round``."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = absmax / 127.0
    q = torch.where(
        scale > 0, torch.round(x / torch.clamp_min(scale, 1e-30)), torch.zeros_like(x)
    ).to(torch.int8)
    return q, scale.reshape(1, -1)


def exclusion_mask(
    num_items: int,
    exclude_items: Optional[torch.Tensor] = None,
    exclude_count: Optional[torch.Tensor] = None,
    exclude_slots: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense int8 [B, I] exclusion mask from padded per-user exclusion lists.
    Negative entries (the -1 pad), ids ≥ ``num_items`` and slots beyond
    ``exclude_count`` are ignored. Written at fixed shapes, as
    ``ops/topk.apply_exclusion``: ignored slots set a spare byte past the
    mask, so nothing waits for the card. ``exclude_slots`` ([B, X], from
    ``exclusion_slots(num_items, ...)``) may stand in for items and counts."""
    if exclude_slots is None:
        exclude_slots = exclusion_slots(num_items, exclude_items, exclude_count)
    b = exclude_slots.shape[0]
    buf = torch.zeros(b * num_items + 1, dtype=torch.int8, device=exclude_slots.device)
    buf.index_fill_(0, exclude_slots.reshape(-1), 1)
    return buf[: b * num_items].view(b, num_items)


def streaming_mips_topk_plain(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    k: int,
    excl_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B."""
    scores = user_emb.float() @ item_emb.float().T
    if excl_mask is not None:
        scores = scores.masked_fill(excl_mask != 0, NEG_INF)
    return topk_fold_plain(scores, k)


def streaming_mips_topk_lists_plain(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    k: int,
    exclude_items: torch.Tensor,
    exclude_count: torch.Tensor,
    fill: float = EXCLUDE_FILL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B's list route: full scores, ``fill``
    at every valid slot (an id in the catalog, at a slot below the row's
    count), the fold's order. Raises where a row's first ``count`` ids
    (clamped to [0, X]) are not in ascending order, which the kernel
    assumes and does not check."""
    x = exclude_items.shape[1]
    inside = torch.arange(1, x, device=exclude_items.device) < exclude_count[:, None]
    if bool(((exclude_items.diff(dim=1) < 0) & inside).any()):
        raise ValueError("exclusion rows must hold their first count ids in ascending order "
                         "(ops/topk.sorted_exclusions)")
    scores = user_emb.float() @ item_emb.float().T
    return topk_fold_plain(apply_exclusion(scores, exclude_items, exclude_count, fill), k)


def streaming_mips_topk_int8_plain(
    user_emb: torch.Tensor,
    q_items: torch.Tensor,
    item_scales: torch.Tensor,
    k: int,
    excl_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C: exact integer dot products, then
    (raw · su) · si in f32, the kernel's own roundings."""
    qu, su = row_quantize(user_emb.float())
    # f64 holds every int8·int8 dot product exactly (|raw| ≤ D·127² ≪ 2⁵³)
    raw = qu.to(torch.float64) @ q_items.to(torch.float64).T
    scores = raw.to(torch.float32) * su.reshape(-1, 1) * item_scales.reshape(1, -1)
    if excl_mask is not None:
        scores = scores.masked_fill(excl_mask != 0, NEG_INF)
    return topk_fold_plain(scores, k)


def _check_k(k: int) -> int:
    k = int(k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    return k


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


@functools.lru_cache(maxsize=None)
def _plan(kernel: str, b: int, i: int, d: int, k: int, device_index: int) -> Tuple[int, int]:
    """(num_splits, split_len) of the catalog for kernel ``kernel`` on the
    current card, from its C-side plan. Cached per shape, so a server's
    repeated batches skip the plan's CUDA queries. Raises where a block at
    (d, k) needs more shared memory than the card has."""
    source, signatures, _, plan_fn = _KERNELS[kernel]
    lib = _build.load(source, signatures)
    smem = _smem_bytes(kernel, d, k)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"D={d}, k={k} needs {smem} B of shared memory per block")
    plan = (ctypes.c_int64 * 2)()
    _build.check(getattr(lib, plan_fn)(b, i, d, k, ctypes.cast(plan, _P)), plan_fn)
    return int(plan[0]), int(plan[1])


def _outputs(b: int, s: int, k: int, device):
    """The per-split lists (part_v, part_i) and the result (vals, idx)."""
    return (torch.empty((b, s, k), dtype=torch.float32, device=device),
            torch.empty((b, s, k), dtype=torch.int32, device=device),
            torch.empty((b, k), dtype=torch.float32, device=device),
            torch.empty((b, k), dtype=torch.int32, device=device))


def _mask_ptr(excl_mask, b, i, device):
    if excl_mask is None:
        return None
    _check(excl_mask, "excl_mask", torch.int8, (b, i), device)
    return excl_mask.data_ptr()


def pad_columns(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into a fresh zero-padded [N, ⌈D/4⌉·4] tensor (aligned
    by the allocator)."""
    n, d = x.shape
    out = x.new_zeros((n, -(-d // 4) * 4))
    out[:, :d] = x
    return out


def kernel_b_fits(d: int, k: int) -> bool:
    """Whether a block of kernel B at width ``d`` (padded to a multiple of
    4) and ``k`` fits the card's shared memory (a call on the card)."""
    return _smem_bytes("topk_f32", -(-int(d) // 4) * 4, int(k)) <= _MAX_SMEM_BYTES


@functools.lru_cache(maxsize=None)
def _smem_bytes(kernel: str, d: int, k: int) -> int:
    source, signatures, smem_fn, _ = _KERNELS[kernel]
    return int(getattr(_build.load(source, signatures), smem_fn)(d, k))


def _f32_operands(user_emb, item_emb):
    """Kernel B's checked operands: (users, items, b, i, d, device), the
    tables zero-padded to a width that is a multiple of 4."""
    dev = user_emb.device
    b, d = user_emb.shape
    i = int(item_emb.shape[0])
    _check(user_emb, "user_emb", torch.float32, (b, d), dev)
    _check(item_emb, "item_emb", torch.float32, (i, d), dev)
    if d % 4:
        user_emb, item_emb = pad_columns(user_emb), pad_columns(item_emb)
        d = int(user_emb.shape[1])
    if user_emb.data_ptr() % 16 or item_emb.data_ptr() % 16:
        raise ValueError(f"kernel B takes 16-byte aligned tensors, got D={d}")
    return user_emb, item_emb, b, i, d, dev


def streaming_mips_topk(
    user_emb: torch.Tensor,   # f32 [B, D]
    item_emb: torch.Tensor,   # f32 [I, D]
    k: int,
    excl_mask: Optional[torch.Tensor] = None,   # int8 [B, I], 1 = excluded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product items per user: (values f32 [B, k], ids int32
    [B, k]) — kernel B."""
    k = _check_k(k)
    dev = user_emb.device
    if dev.type == "cpu":
        return streaming_mips_topk_plain(user_emb, item_emb, k, excl_mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    user_emb, item_emb, b, i, d, dev = _f32_operands(user_emb, item_emb)
    mask_ptr = _mask_ptr(excl_mask, b, i, dev)
    s, split_len = _plan("topk_f32", b, i, d, k, dev.index)
    part_v, part_i, vals, idx = _outputs(b, s, k, dev)
    lib = _build.load("topk_f32", _F32_SIGNATURES)
    rc = lib.topk_f32_launch(
        user_emb.data_ptr(), item_emb.data_ptr(), mask_ptr, b, i, d, k, s, split_len,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(rc, "topk_f32_launch")
    _build.launches["topk_f32"] += 1
    return vals, idx


def streaming_mips_topk_lists(
    user_emb: torch.Tensor,        # f32 [B, D]
    item_emb: torch.Tensor,        # f32 [I, D]
    k: int,
    exclude_items: torch.Tensor,   # int32 [B, X], ascending in each row's first count slots
    exclude_count: torch.Tensor,   # int32 [B]
    fill: float = EXCLUDE_FILL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product items per user with exclusion lists: (values f32
    [B, k], ids int32 [B, k]) — kernel B's list route. An excluded item
    scores ``fill`` and stays a candidate. The first ``count`` ids of each
    row must be in ascending order (``ops/topk.sorted_exclusions``): the
    kernel does not check it, its plain version raises. Counts are clamped
    to [0, X], and ids outside the catalog are never met. Launches count
    under ``topk_f32_lists``."""
    k = _check_k(k)
    dev = user_emb.device
    if dev.type == "cpu":
        return streaming_mips_topk_lists_plain(user_emb, item_emb, k, exclude_items,
                                               exclude_count, fill)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    user_emb, item_emb, b, i, d, dev = _f32_operands(user_emb, item_emb)
    x = int(exclude_items.shape[1])
    _check(exclude_items, "exclude_items", torch.int32, (b, x), dev)
    _check(exclude_count, "exclude_count", torch.int32, (b,), dev)
    s, split_len = _plan("topk_f32", b, i, d, k, dev.index)
    part_v, part_i, vals, idx = _outputs(b, s, k, dev)
    lib = _build.load("topk_f32", _F32_SIGNATURES)
    rc = lib.topk_f32_lists_launch(
        user_emb.data_ptr(), item_emb.data_ptr(), exclude_items.data_ptr(),
        exclude_count.data_ptr(), x, float(fill), b, i, d, k, s, split_len,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(rc, "topk_f32_lists_launch")
    _build.launches["topk_f32_lists"] += 1
    return vals, idx


def streaming_mips_topk_masked(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    excl_mask: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k with exclusion masking (the JAX signature order)."""
    return streaming_mips_topk(user_emb, item_emb, k, excl_mask)


def streaming_mips_topk_int8(
    user_emb: torch.Tensor,      # f32 [B, D]
    q_items: torch.Tensor,       # int8 [I, D] (row_quantize)
    item_scales: torch.Tensor,   # f32 [1, I]
    k: int,
    excl_mask: Optional[torch.Tensor] = None,   # int8 [B, I], 1 = excluded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized streaming retrieval over an int8 catalog — kernel C. Users
    are row-quantized on the fly; scores are (qu·qi) · su · si."""
    k = _check_k(k)
    dev = user_emb.device
    if dev.type == "cpu":
        return streaming_mips_topk_int8_plain(user_emb, q_items, item_scales, k, excl_mask)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, d = user_emb.shape
    i = int(q_items.shape[0])
    _check(q_items, "q_items", torch.int8, (i, d), dev)
    _check(item_scales, "item_scales", torch.float32, (1, i), dev)
    mask_ptr = _mask_ptr(excl_mask, b, i, dev)
    qu, su = row_quantize(user_emb.float())
    qu, su = qu.contiguous(), su.reshape(-1).contiguous()
    s, split_len = _plan("topk_int8", b, i, d, k, dev.index)
    part_v, part_i, vals, idx = _outputs(b, s, k, dev)
    lib = _build.load("topk", _SIGNATURES)
    rc = lib.topk_int8_launch(
        qu.data_ptr(), su.data_ptr(), q_items.data_ptr(), item_scales.data_ptr(), mask_ptr,
        b, i, d, k, s, split_len,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(rc, "topk_int8_launch")
    _build.launches["topk_int8"] += 1
    return vals, idx
