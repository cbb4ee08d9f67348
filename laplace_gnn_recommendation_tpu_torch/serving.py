"""Batch serving — counterpart of the JAX package's ``serving.py``.

* :class:`RetrievalServer` holds user/item embedding tables on the device
  and answers ``recommend(user_ids)`` with exclusion-masked top-k MIPS.
* :class:`RankingServer` re-ranks matcher candidates: padded subgraph batch
  (host sampler) → hetero SAGE ``infer`` on the device → top-k item ids.

Requests of any size are cut into one fixed batch shape; the tail batch is
padded and its pad rows dropped from the answer.

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
from .data.sampler import SubgraphSampler, derive_budgets
from .models import sage
from .ops.topk import STREAMING_MAX_BATCH, auto_mips_topk, mips_topk_int8, top_k_lowest_first
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


class RankingServer:
    """Matcher candidates → hetero SAGE scoring → top-k per user (JAX
    ``serving.py:264-388``; the reference's ``run_submission.py:48-69`` flow
    as a service). Runs on the device of ``data``'s tables."""

    def __init__(
        self,
        cfg,
        data,                      # LinkPredData (serving split = "test")
        params: "sage.SageModel",
        bn_state: dict,
        split: str = "test",
        exclude_seen: bool = True,
    ):
        """``exclude_seen`` (default) masks EVERY already-interacted item of
        the split, which is what a server must do. ``False`` reproduces the
        reference's submission filter exactly (``run_submission.py:60-66``
        keeps label-0 edges only) — including its quirk that positives no
        matcher proposed re-enter the candidate set with label 0."""
        self.cfg = cfg
        self.data = data
        self.params = params
        self.bn_state = bn_state
        self.device = data.device
        adj = data.splits[split]
        if exclude_seen:
            csr = adj.user_csr
            self._seen, self._seen_count = padded_user_items(
                np.arange(data.num_users, dtype=np.int32),
                np.repeat(np.arange(data.num_users, dtype=np.int64),
                          np.asarray(csr.degrees, np.int64)),
                csr.cols.astype(np.int64),
            )
        else:
            self._seen = self._seen_count = None
        max_deg = max(int(a.user_csr.degrees.max(initial=1)) for a in data.splits.values())
        budgets = derive_budgets(
            cfg, max_deg, max(len(m) for m in data.matchers.values()),
            num_users=data.num_users, num_items=data.num_items,
        )
        self.sampler = SubgraphSampler(
            cfg, adj.user_csr, adj.item_csr, train=False,
            matchers=data.matchers[split], seed=0, budgets=budgets,
        )

    @torch.no_grad()
    def _infer_topk(self, batch, seen, seen_count, k: int):
        d = self.data
        scores = sage.infer(
            self.params, self.bn_state, batch, d.user_features, d.item_features, self.cfg,
            user_features_float=d.user_features_float, item_features_float=d.item_features_float,
            item_extra_ids=d.item_extra_ids, extra_features=d.extra_features,
        )
        pad = torch.full_like(scores, sage.INFER_PAD)
        # candidates only: positives are already interacted → excluded
        scores = torch.where(batch.label > 0, pad, scores)
        if seen is not None:
            # strict serving mode: drop anything the user interacted with,
            # even label-0 XOR re-entries
            valid_seen = torch.arange(seen.shape[1], device=seen.device)[None, :] < seen_count[:, None]
            seen = torch.where(valid_seen, seen, torch.full_like(seen, -1))
            hit = (batch.label_item_global[:, :, None] == seen[:, None, :]).any(-1)
            scores = torch.where(hit, pad, scores)
        # ties in ascending slot order, as jax.lax.top_k: pad slots all hold
        # INFER_PAD and are masked below, so only real ties depend on it
        vals, pos = top_k_lowest_first(scores, k)
        items = torch.gather(batch.label_item_global, 1, pos)
        valid = torch.gather(batch.label_mask, 1, pos) & (vals > sage.INFER_PAD / 2)
        return torch.where(valid, items, torch.full_like(items, -1)), vals

    def recommend(self, user_ids: Sequence[int], k: Optional[int] = None) -> np.ndarray:
        """Top-k candidate item ids per user ([N, k], -1 pads rows whose
        candidate pool ran short — including cold users with no interactions
        in the serving split, who get all -1)."""
        k = self.cfg.k if k is None else int(k)
        users = np.asarray(user_ids, np.int64)
        n = len(users)
        b = self.cfg.batch_size
        out = np.full((n, k), -1, np.int32)
        # the candidate grid is budgets.labels_per_user wide; top-k cannot
        # ask for more
        k_run = min(k, self.sampler.budgets.labels_per_user)
        # cold users (no interactions in this split) cannot be sampled: the
        # positive draw needs degree ≥ 1; they answer -1
        warm_mask = self.sampler.users.degrees[users] > 0
        warm_pos = np.nonzero(warm_mask)[0]
        warm_users = users[warm_mask]
        dev = self.device
        for s in range(0, len(warm_users), b):
            e = min(s + b, len(warm_users))
            chunk = warm_users[s:e]
            if e - s < b:
                chunk = np.concatenate([chunk, np.full(b - (e - s), chunk[-1])])
            batch = self.sampler.sample_batch(chunk, valid_rows=e - s).to(dev)
            seen = seen_count = None
            if self._seen is not None:
                seen = torch.from_numpy(self._seen[chunk]).to(dev)
                seen_count = torch.from_numpy(self._seen_count[chunk]).to(dev)
            items, _ = self._infer_topk(batch, seen, seen_count, k_run)
            out[warm_pos[s:e], :k_run] = items.cpu().numpy()[: e - s]
        return out
