"""Batch serving — counterpart of the JAX package's ``serving.py``.

* :class:`RetrievalServer` holds user/item embedding tables on the device
  and answers ``recommend(user_ids)`` with exclusion-masked top-k MIPS.
* :class:`RankingServer` re-ranks matcher candidates: padded subgraph batch
  (host sampler) → hetero SAGE ``infer`` on the device → top-k item ids.

Requests of any size are cut into one fixed batch shape; the tail batch is
padded and its pad rows dropped from the answer.

``RetrievalServer`` picks its route once a k (``_step``); each route owns its
exclusion encoding and the catalog's pad tail:

* f32 on a card where ``ops/topk.streams_f32`` holds: kernel B reads each
  batch's slice of the sorted exclusion lists; no [batch, I] scores;
* f32 elsewhere: positions (``ops/topk.exclusion_slots``) and ``mips_topk``;
* ``quantized=True`` (int8, never quietly f32): kernel C on a dense mask
  holding the pad tail; past ``STREAMING_MAX_BATCH`` rows, ``mips_topk_int8``
  with the tail's positions joined to the exclusions;
* a ``mesh`` with a model axis > 1 (both servers are built and called on
  every rank; it wins over ``quantized``, JAX ``:73-79``): this rank's block
  of a catalog padded to divide the axis, positions at its offset,
  ``ops/topk.sharded_mips_topk`` with the pad tail at ``-inf``.
  ``RankingServer`` runs with its feature tables row-sharded (JAX ``:319-331``).
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
from .ops.topk import (
    STREAMING_MAX_BATCH,
    exclusion_slots,
    mips_topk,
    mips_topk_int8,
    sharded_mips_topk,
    sorted_exclusions,
    streams_f32,
    top_k_lowest_first,
)
from .parallel.mesh import model_parts, round_up
from .ops.topk_pallas import (
    exclusion_mask,
    row_quantize,
    streaming_mips_topk,
    streaming_mips_topk_int8,
    streaming_mips_topk_lists,
)
from .utils.profiling import tracer

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
        mesh=None,
    ):
        """``exclude_edges=(edge_user, edge_item)`` marks already-seen items
        that are never recommended (the train interactions).

        ``quantized=True`` stores the catalog as per-row int8 (4× less
        device memory; approximate retrieval), padded internally with zero
        rows to a multiple of ``QUANTIZED_TILE``; the pad rows are masked
        out of every answer.

        ``mesh`` with a model axis > 1: the whole tables are given on every
        rank; this rank keeps its row block of the catalog, padded with zero
        rows to divide the axis, and the tables live on the mesh's device."""
        dev = mesh.device if mesh is not None else resolve_device(device)
        self.device = dev
        self.mesh = mesh
        parts = model_parts(mesh)
        self._sharded = parts > 1
        self.user_emb = _f32_on(user_emb, dev)
        items = _f32_on(item_emb, dev)
        self.num_users, self.dim = self.user_emb.shape
        self.num_items = int(items.shape[0])   # true catalog size
        self.k = int(k)
        self.batch_size = int(batch_size)
        self.quantized = bool(quantized) and not self._sharded

        mult = (QUANTIZED_TILE if self.quantized else 1) * parts
        self.items_padded = round_up(self.num_items, mult)
        if self.items_padded != self.num_items:
            items = torch.cat(
                [items, items.new_zeros((self.items_padded - self.num_items, self.dim))]
            )
        if self._sharded:
            lo, hi = mesh.row_range(self.items_padded)
            items = items[lo:hi].contiguous()
        self.item_emb = items
        if self.quantized:
            q, s = row_quantize(self.item_emb)
            self._q_items, self._item_scales = q.contiguous(), s.contiguous()
        # the exclusion table lives on the device, each row's catalog ids in
        # ascending order, -1 after (kernel B's list route reads it so; the
        # other routes take any order); each request gathers its rows there.
        # The host keeps the counts alone, for the tracer.
        self._ex = self._exc = self._exc_host = None
        if exclude_edges is not None:
            eu, ei = exclude_edges
            ex, exc = padded_user_items(
                np.arange(self.num_users, dtype=np.int32),
                np.asarray(eu, np.int64), np.asarray(ei),
            )
            self._ex, self._exc = sorted_exclusions(
                self.num_items, torch.from_numpy(ex).to(dev), torch.from_numpy(exc).to(dev))
            self._exc_host = self._exc.cpu().numpy()
        self._steps = {}
        self._step(self.k)

    @classmethod
    def from_lightgcn_artifacts(
        cls,
        artifact_dir: str,
        k: int = 12,
        exclude_edges=None,
        batch_size: int = 256,
        quantized: bool = False,
        device="cuda",
        mesh=None,
    ) -> "RetrievalServer":
        """Serve the tables written by ``lightgcn_pipeline.export_artifacts``."""
        z = np.load(os.path.join(artifact_dir, "lightgcn_embeddings.npz"))
        return cls(
            z["users_emb_final"], z["items_emb_final"], k=k,
            exclude_edges=exclude_edges, batch_size=batch_size,
            quantized=quantized, device=device, mesh=mesh,
        )

    def _step(self, k: int):
        """(prepare, run) at ``k``, built at its first use and kept: the one
        place the route is chosen. ``prepare(rows, counts)``, once a request,
        turns its gathered exclusion rows [batches, b, X] and counts
        [batches, b] (``None`` without a table) into operands with a leading
        batch axis; ``run(uvec, *operands_j)`` issues one batch and returns
        its (values, ids) on the device without waiting."""
        if k in self._steps:
            return self._steps[k]
        b, n, n_pad, items = self.batch_size, self.num_items, self.items_padded, self.item_emb

        def slots_in(cols, offset=0):
            # each batch's exclusion positions in its [b, cols] scores
            return lambda rows, counts: () if rows is None else (
                exclusion_slots(cols, rows, counts, offset),)

        prepare = slots_in(n_pad)
        if self._sharded:
            lo, hi = self.mesh.row_range(n_pad)
            prepare = slots_in(hi - lo, lo)

            def run(uvec, slots=None):
                return sharded_mips_topk(self.mesh, uvec, items, k, num_valid_items=n,
                                         exclude_slots=slots)
        elif self.quantized and b > STREAMING_MAX_BATCH:
            # pad rows quantize to scale 0 → score 0, which would outrank
            # negative real scores: one batch's tail positions join the slots
            tail = None if n_pad == n else exclusion_slots(
                n_pad, torch.arange(n, n_pad, device=self.device).expand(b, -1))

            def run(uvec, slots=None):
                if tail is not None:
                    slots = tail if slots is None else torch.cat([tail, slots], dim=1)
                return mips_topk_int8(uvec, self._q_items, self._item_scales, k,
                                      exclude_slots=slots)
        elif self.quantized:
            def run(uvec, slots=None):   # kernel C: a dense mask, the pad tail set
                mask = None if slots is None else exclusion_mask(n_pad, exclude_slots=slots)
                if n_pad != n:
                    if mask is None:
                        mask = torch.zeros((uvec.shape[0], n_pad), dtype=torch.int8,
                                           device=uvec.device)
                    mask[:, n:] = 1
                return streaming_mips_topk_int8(uvec, self._q_items, self._item_scales, k,
                                                excl_mask=mask)
        elif streams_f32(self.device.type, b, n, self.dim, k):
            def prepare(rows, counts):   # kernel B reads the sorted rows as they are
                return () if rows is None else (rows, counts)

            def run(uvec, rows=None, counts=None):
                tracer.count("retrieve.streamed_batches")
                if rows is None:
                    return streaming_mips_topk(uvec, items, k)
                return streaming_mips_topk_lists(uvec, items, k, rows, counts)
        else:
            def run(uvec, slots=None):
                return mips_topk(uvec, items, k, exclude_slots=slots)
        return self._steps.setdefault(k, (prepare, run))

    def recommend(
        self, user_ids: Sequence[int], k: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(item_ids int32 [N, k], scores f32 [N, k]) for any request size.

        The request's ids go to the device in one copy, padded to whole
        batches; its users' rows and exclusion rows are gathered there and
        turned, once a request, into what the route at ``k`` reads (the
        module's docstring); each batch then issues product, exclusion and
        top-k on its slices without waiting on the device; the answer comes
        back in one copy of ids and one of scores, the request's only wait.

        Spans of :data:`tracer`: ``retrieve.request`` is the root, with
        children ``retrieve.upload`` (the copy, the gathers and the
        exclusion positions, once), one ``retrieve.batch`` a batch holding
        one ``retrieve.score`` (the issue of product, exclusion and top-k)
        and ``retrieve.readback`` (once). Counters:
        ``retrieve.exclusion_slots`` (padded rows × exclusion width) and
        ``retrieve.excluded_ids`` (the valid ids among them), from the host
        counts; ``retrieve.host_waits``, one at every point where the host
        waits for the device (the readback; the sharded tier's collectives
        are not counted); ``retrieve.streamed_batches``, one a batch that
        kernel B answers."""
        k = self.k if k is None else int(k)
        prepare, run = self._step(k)
        users = np.asarray(user_ids, np.int64)
        n = len(users)
        b = self.batch_size
        if n == 0:
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
        batches = -(-n // b)
        padded = np.zeros(batches * b, np.int64)
        padded[:n] = users
        with tracer.span("retrieve.request"):
            if self._ex is not None and tracer.on:
                tracer.count("retrieve.exclusion_slots", padded.size * self._ex.shape[1])
                tracer.count("retrieve.excluded_ids", int(self._exc_host[padded].sum()))
            with tracer.span("retrieve.upload"):
                ids = torch.from_numpy(padded)
                if self.device.type == "cuda":
                    ids = ids.pin_memory().to(self.device, non_blocking=True)
                uvecs = self.user_emb.index_select(0, ids).view(batches, b, -1)
                rows = counts = None
                if self._ex is not None:
                    rows = self._ex.index_select(0, ids).view(batches, b, -1)
                    counts = self._exc.index_select(0, ids).view(batches, b)
                operands = prepare(rows, counts)
            parts = []
            for j in range(batches):
                with tracer.span("retrieve.batch"), tracer.span("retrieve.score"):
                    # one view a batch, as it is issued (unbinding all at
                    # once would hold the first product back)
                    parts.append(run(uvecs[j], *[t[j] for t in operands]))
            with tracer.span("retrieve.readback"):
                return self._readback(parts, n)

    @staticmethod
    def _readback(parts, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """The first ``n`` rows of the batches' (values, ids), in one copy
        each to the host and one wait."""
        vals = torch.cat([v for v, _ in parts])[:n]
        idx = torch.cat([i for _, i in parts])[:n]
        tracer.count("retrieve.host_waits")
        if vals.device.type != "cuda":
            return idx.numpy(), vals.numpy()
        stream = torch.cuda.current_stream(vals.device)
        vals, idx = vals.to("cpu", non_blocking=True), idx.to("cpu", non_blocking=True)
        stream.synchronize()
        # out of pinned memory, which the caller may hold for long
        return idx.numpy().copy(), vals.numpy().copy()


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
        mesh=None,
    ):
        """``exclude_seen`` (default) masks EVERY already-interacted item of
        the split, which is what a server must do. ``False`` reproduces the
        reference's submission filter exactly (``run_submission.py:60-66``
        keeps label-0 edges only) — including its quirk that positives no
        matcher proposed re-enter the candidate set with label 0.

        ``mesh`` with a model axis > 1: ``params``' feature tables are this
        rank's row blocks (``init_sage_params(mesh=)``), and every rank
        answers every request."""
        self.cfg = cfg
        self.mesh = mesh if model_parts(mesh) > 1 else None
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
            item_extra_ids=d.item_extra_ids, extra_features=d.extra_features, mesh=self.mesh,
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
