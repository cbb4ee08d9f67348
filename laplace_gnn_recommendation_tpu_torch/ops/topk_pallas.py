"""Streaming MIPS top-k — the port of the JAX package's ``ops/topk_pallas.py``.

Kernel B (``csrc/topk_f32.cu``) replaces the Pallas kernels ``_kernel`` and
``_kernel_masked``; kernel C (``csrc/topk.cu``, ``topk_int8_launch``)
replaces ``_kernel_int8`` and ``_kernel_int8_masked``. Each takes an
optional int8 exclusion mask. The [B, I] score matrix never reaches device
memory: item tiles are staged in shared memory and folded into a running
k-best list per user; the catalog is cut into ranges that blocks fold in
parallel, and a merge pass combines each user's lists. Kernel B takes
widths that are a multiple of 4 on 16-byte aligned tensors.

Semantics (those of the Pallas fold ``_fold_topk``): the k best items by
(score descending, item id ascending); slots no item fills hold
(``NEG_INF``, id 0); excluded items score ``NEG_INF`` and never displace an
unfilled slot. ``k`` is at most ``MAX_K``.

Every wrapper launches its kernel for tensors on the card and runs the
plain version (``*_plain``: full scores, stable sort) for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build

NEG_INF = float(np.finfo(np.float32).min)
MAX_K = 256
_USERS_PER_BLOCK = 8
_MIN_SPLIT_ITEMS = 1024
_MAX_SMEM_BYTES = 232_448

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "topk_int8_launch": [_P, _P, _P, _P, _P] + [_I64] * 6 + [_P] * 5,
    "topk_smem_bytes": [_I64, _I64, _I64],
}
_F32_SIGNATURES = {
    "topk_f32_launch": [_P, _P, _P] + [_I64] * 6 + [_P] * 5,
    "topk_f32_plan": [_I64] * 4 + [_P],
    "topk_f32_smem_bytes": [_I64, _I64],
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
    exclude_items: torch.Tensor,
    exclude_count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense int8 [B, I] exclusion mask from padded per-user exclusion lists.
    Negative entries (the -1 pad), ids ≥ ``num_items`` and slots beyond
    ``exclude_count`` are ignored."""
    b, x = exclude_items.shape
    dev = exclude_items.device
    valid = (exclude_items >= 0) & (exclude_items < num_items)
    if exclude_count is not None:
        valid &= torch.arange(x, device=dev)[None, :] < exclude_count[:, None]
    rows = torch.arange(b, device=dev)[:, None].expand(b, x)
    mask = torch.zeros((b, num_items), dtype=torch.int8, device=dev)
    mask[rows[valid], exclude_items[valid].long()] = 1
    return mask


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


def _splits(b: int, i: int, device) -> Tuple[int, int]:
    """(num_splits, split_len): enough blocks for a few per SM, at least
    ``_MIN_SPLIT_ITEMS`` items a split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = -(-b // _USERS_PER_BLOCK)
    s = -(-4 * sms // groups)
    s = max(1, min(s, -(-i // _MIN_SPLIT_ITEMS), 65535))
    return s, -(-i // s)


def _launch_int8(b: int, i: int, d: int, k: int, device, args_in):
    lib = _build.load("topk", _SIGNATURES)
    smem = lib.topk_smem_bytes(d, k, 1)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"D={d}, k={k} needs {smem} B of shared memory per block")
    s, split_len = _splits(b, i, device)
    part_v = torch.empty((b, s, k), dtype=torch.float32, device=device)
    part_i = torch.empty((b, s, k), dtype=torch.int32, device=device)
    vals = torch.empty((b, k), dtype=torch.float32, device=device)
    idx = torch.empty((b, k), dtype=torch.int32, device=device)
    rc = lib.topk_int8_launch(
        *args_in, b, i, d, k, s, split_len,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        _build.stream_ptr(device),
    )
    _build.check(rc, "topk_int8_launch")
    return vals, idx


def _mask_ptr(excl_mask, b, i, device):
    if excl_mask is None:
        return None
    _check(excl_mask, "excl_mask", torch.int8, (b, i), device)
    return excl_mask.data_ptr()


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
    b, d = user_emb.shape
    i = int(item_emb.shape[0])
    _check(user_emb, "user_emb", torch.float32, (b, d), dev)
    _check(item_emb, "item_emb", torch.float32, (i, d), dev)
    if d % 4 or user_emb.data_ptr() % 16 or item_emb.data_ptr() % 16:
        raise ValueError(
            f"kernel B takes widths that are a multiple of 4 on 16-byte aligned "
            f"tensors, got D={d}"
        )
    mask_ptr = _mask_ptr(excl_mask, b, i, dev)
    lib = _build.load("topk_f32", _F32_SIGNATURES)
    smem = lib.topk_f32_smem_bytes(d, k)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"D={d}, k={k} needs {smem} B of shared memory per block")
    plan = (ctypes.c_int64 * 2)()
    _build.check(lib.topk_f32_plan(b, i, d, k, ctypes.cast(plan, _P)), "topk_f32_plan")
    s, split_len = plan
    part_v = torch.empty((b, s, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, s, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    rc = lib.topk_f32_launch(
        user_emb.data_ptr(), item_emb.data_ptr(), mask_ptr, b, i, d, k, s, split_len,
        part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(rc, "topk_f32_launch")
    _build.launches["topk_f32"] += 1
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
    out = _launch_int8(
        b, i, d, k, dev,
        (qu.data_ptr(), su.data_ptr(), q_items.data_ptr(), item_scales.data_ptr(), mask_ptr),
    )
    _build.launches["topk_int8"] += 1
    return out
