"""Batch retrieval serving — counterpart of the JAX package's ``serving.py``
(``RetrievalServer``; ``RankingServer`` comes with the ranking slice).

:class:`RetrievalServer` holds user/item embedding tables on the device and
answers ``recommend(user_ids)`` with exclusion-masked top-k MIPS. Requests
of any size are cut into one fixed batch shape; the tail batch is padded
and its pad rows dropped from the answer.

``quantized=True`` stores the catalog as per-row int8 and retrieves through
the int8 streaming kernel (kernel C) on the card, or its plain version on
the CPU; it never quietly serves f32 instead.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .data.lightgcn_data import padded_user_items
from .ops.topk import STREAMING_MAX_BATCH, auto_mips_topk, mips_topk_int8
from .ops.topk_pallas import exclusion_mask, row_quantize, streaming_mips_topk_int8

QUANTIZED_TILE = 2048  # catalog rows are padded to a multiple of this


def _f32_on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


class RetrievalServer:
    """Top-k MIPS retrieval over full device-resident embedding tables."""

    def __init__(
        self,
        user_emb,                       # [U, D] numpy array or tensor
        item_emb,                       # [I, D]
        k: int = 12,
        exclude_edges: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        batch_size: int = 256,
        quantized: bool = False,
        device="cuda",
    ):
        """``exclude_edges=(edge_user, edge_item)`` marks already-seen items
        that are never recommended (the train interactions).

        ``quantized=True`` stores the catalog as per-row int8 (4× less
        device memory; approximate retrieval), padded internally with zero
        rows to a multiple of ``QUANTIZED_TILE``; the pad rows are masked
        out of every answer."""
        dev = resolve_device(device)
        self.device = dev
        self.user_emb = _f32_on(user_emb, dev)
        items = _f32_on(item_emb, dev)
        self.num_users, self.dim = self.user_emb.shape
        self.num_items = int(items.shape[0])   # true catalog size
        self.k = int(k)
        self.batch_size = int(batch_size)
        self.quantized = bool(quantized)

        mult = QUANTIZED_TILE if self.quantized else 1
        self.items_padded = -(-self.num_items // mult) * mult
        if self.items_padded != self.num_items:
            items = torch.cat(
                [items, items.new_zeros((self.items_padded - self.num_items, self.dim))]
            )
        self.item_emb = items
        self._has_tail = self.items_padded != self.num_items
        if self.quantized:
            q, s = row_quantize(self.item_emb)
            self._q_items, self._item_scales = q.contiguous(), s.contiguous()
            # pad rows quantize to scale 0 → score 0, which would outrank
            # negative real scores: they are excluded explicitly
            self._tail_ex = torch.arange(
                self.num_items, self.items_padded, dtype=torch.int32, device=dev
            )
        if exclude_edges is not None:
            eu, ei = exclude_edges
            self._ex, self._exc = padded_user_items(
                np.arange(self.num_users, dtype=np.int32),
                np.asarray(eu, np.int64), np.asarray(ei),
            )
        else:
            self._ex = self._exc = None

    @classmethod
    def from_lightgcn_artifacts(
        cls,
        artifact_dir: str,
        k: int = 12,
        exclude_edges=None,
        batch_size: int = 256,
        quantized: bool = False,
        device="cuda",
    ) -> "RetrievalServer":
        """Serve the tables written by ``lightgcn_pipeline.export_artifacts``."""
        z = np.load(os.path.join(artifact_dir, "lightgcn_embeddings.npz"))
        return cls(
            z["users_emb_final"], z["items_emb_final"], k=k,
            exclude_edges=exclude_edges, batch_size=batch_size,
            quantized=quantized, device=device,
        )

    def _quantized_step(self, uvec, ex, exc, k):
        b = uvec.shape[0]
        if self.batch_size > STREAMING_MAX_BATCH:
            # materializing int8 path; tail exclusions go FIRST, because
            # exclude_count validity is positional
            if self._has_tail:
                n_tail = self._tail_ex.shape[0]
                tail = self._tail_ex[None, :].expand(b, n_tail)
                if ex is None:
                    ex = tail
                    exc = torch.full((b,), n_tail, dtype=torch.int32, device=uvec.device)
                else:
                    ex = torch.cat([tail, ex.to(torch.int32)], dim=1)
                    exc = exc + n_tail
            return mips_topk_int8(uvec, self._q_items, self._item_scales, k, ex, exc)
        mask = None
        if ex is not None:
            mask = exclusion_mask(self.items_padded, ex, exc)
        if self._has_tail:
            if mask is None:
                mask = torch.zeros((b, self.items_padded), dtype=torch.int8, device=uvec.device)
            mask[:, self.num_items:] = 1
        return streaming_mips_topk_int8(
            uvec, self._q_items, self._item_scales, k, excl_mask=mask
        )

    def recommend(
        self, user_ids: Sequence[int], k: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(item_ids int32 [N, k], scores f32 [N, k]) for any request size."""
        k = self.k if k is None else int(k)
        users = np.asarray(user_ids, np.int64)
        n = len(users)
        b = self.batch_size
        out_items = np.zeros((n, k), np.int32)
        out_scores = np.zeros((n, k), np.float32)
        for s in range(0, n, b):
            e = min(s + b, n)
            chunk = np.pad(users[s:e], (0, b - (e - s)))
            uvec = self.user_emb[torch.from_numpy(chunk).to(self.device)]
            ex = exc = None
            if self._ex is not None:
                ex = torch.from_numpy(self._ex[chunk]).to(self.device)
                exc = torch.from_numpy(self._exc[chunk]).to(self.device)
            if self.quantized:
                vals, idx = self._quantized_step(uvec, ex, exc, k)
            else:
                vals, idx = auto_mips_topk(uvec, self.item_emb, k, ex, exc)
            out_items[s:e] = idx.cpu().numpy()[: e - s]
            out_scores[s:e] = vals.cpu().numpy()[: e - s]
        return out_items, out_scores
