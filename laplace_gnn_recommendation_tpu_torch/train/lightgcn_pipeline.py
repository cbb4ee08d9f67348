"""LightGCN eval / artifact-export pipeline — the serving subset of the JAX
package's ``train/lightgcn_pipeline.py`` (training comes with the next
slice).

Scoring embeddings: the reference's metrics and export consume the **E⁰**
tables (``eval_embeddings="e0"``, the default); ``"final"`` scores with the
propagated embeddings, as in the LightGCN paper.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..configs import LightGCNConfig
from ..data.graph import BipartiteGraph
from ..data.lightgcn_data import EvalSet, LightGCNData, padded_user_items
from ..models.lightgcn import LightGCNParams, lightgcn_forward
from ..ops.metrics import topk_hits
from ..ops.topk import auto_mips_topk, masked_topk


# Node-table size from which the blocked tier gathers in bf16 (the JAX
# package's ``train/lightgcn_pipeline.BF16_GATHER_ROWS``).
BF16_GATHER_ROWS = 1 << 19


def uses_bf16_gather(graph: BipartiteGraph) -> bool:
    """The JAX ``_maybe_bf16`` rule: the blocked tier gathers in bf16 when a
    node table has at least ``BF16_GATHER_ROWS`` rows."""
    return max(graph.num_users, graph.num_items) >= BF16_GATHER_ROWS


def select_propagation(cfg: LightGCNConfig, graph: BipartiteGraph):
    """Propagation operand for ``lightgcn_forward`` (``cfg.propagation``).

    ``plain`` is the numerical reference (``index_add_``); ``pallas`` and
    ``blocked`` — two TPU layouts of one contraction — both map onto the
    segment-sum kernel, ``blocked`` in the bf16-gather mode where the JAX
    package's blocked tier takes it (``uses_bf16_gather``). ``auto`` takes
    the blocked tier's operand on the card (the dense tier is not ported
    yet); on the CPU the plain tier, unless the bf16 rule holds, since the
    bf16 mode computes another function."""
    from ..ops.spmm_pallas import PallasGraph

    mode = getattr(cfg, "propagation", "auto")
    if mode == "plain":
        return graph
    width = cfg.hidden_layer_size
    if mode == "pallas":
        return PallasGraph.from_graph(graph, width=width)
    if mode == "dense":
        raise NotImplementedError(
            "propagation='dense' is not ported yet: the dense tier comes in a "
            "later slice; use 'auto', 'pallas', 'blocked' or 'plain'"
        )
    if mode == "sharded":
        raise NotImplementedError(
            "propagation='sharded' comes with the multi-GPU slice"
        )
    if mode not in ("auto", "blocked"):
        raise ValueError(f"unknown propagation mode {mode!r}")
    bf16 = uses_bf16_gather(graph)
    if mode == "auto" and graph.device.type != "cuda" and not bf16:
        return graph
    return PallasGraph.from_graph(graph, width=width, gather_bf16=bf16)


def _metrics_from_topk(
    topk_items: torch.Tensor,  # int [C, k]
    gt_items: torch.Tensor,    # [C, G]
    gt_count: torch.Tensor,    # [C]
    valid: torch.Tensor,       # bool [C] chunk padding mask
    k: int,
):
    """(recall_sum, hits_sum, ndcg_sum, n) from a top-k id matrix."""
    dev = topk_items.device
    r = topk_hits(topk_items, gt_items, gt_count)
    mask = valid & (gt_count > 0)
    n = mask.sum()
    hits = r.sum(dim=-1).float()
    gtf = gt_count.float()
    zero = torch.zeros((), device=dev)
    recall_sum = torch.where(mask, hits / torch.clamp_min(gtf, 1.0), zero).sum()
    hits_sum = torch.where(mask, hits, zero).sum()
    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32, device=dev))
    dcg = (r.float() * discounts[None, :]).sum(dim=-1)
    ideal_mask = (
        torch.arange(k, device=dev)[None, :] < torch.clamp_max(gt_count, k)[:, None]
    )
    idcg = (ideal_mask.float() * discounts[None, :]).sum(dim=-1)
    ndcg = dcg / torch.where(idcg == 0.0, torch.ones_like(idcg), idcg)
    ndcg_sum = torch.where(mask, ndcg, zero).sum()
    return recall_sum, hits_sum, ndcg_sum, n


def _metrics_chunk(
    user_vecs: torch.Tensor,    # [C, D]
    item_emb: torch.Tensor,     # [I, D]
    gt_items: torch.Tensor,     # [C, G]
    gt_count: torch.Tensor,     # [C]
    excl_items: torch.Tensor,   # [C, X]
    excl_count: torch.Tensor,   # [C]
    valid: torch.Tensor,        # bool [C]
    k: int,
):
    scores = user_vecs @ item_emb.T
    _, topk_items = masked_topk(scores, k, excl_items, excl_count)
    return _metrics_from_topk(topk_items, gt_items, gt_count, valid, k)


def get_metrics(
    params: LightGCNParams,
    cfg: LightGCNConfig,
    eval_set: EvalSet,
    graph_for_final=None,
    eval_embeddings: str = "e0",
    chunk: int = 1024,
) -> Tuple[float, float, float]:
    """recall/precision/ndcg@k over an eval split, chunked over users
    (``utils/metrics_lightgcn.py:79-122`` semantics: scores = user·itemᵀ,
    train edges masked out, topk(k), hits vs the split's ground truth).
    ``graph_for_final`` is the propagation operand for ``"final"``."""
    if eval_embeddings == "final":
        if graph_for_final is None:
            raise ValueError("eval_embeddings='final' needs graph_for_final")
        uf, _, itf, _ = lightgcn_forward(params, graph_for_final, cfg.num_iterations)
        user_emb, item_emb = uf, itf
    elif eval_embeddings == "e0":
        user_emb, item_emb = params.user_emb, params.item_emb
    else:
        raise ValueError(f"unknown eval_embeddings {eval_embeddings!r}")
    dev = user_emb.device

    users = eval_set.users
    cap = getattr(cfg, "eval_user_cap", None)
    if cap is not None and len(users) > cap:
        users = users[:cap]
    b = len(users)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rs = hs = ns = cnt = 0.0
    for s in range(0, b, chunk):
        e = min(s + chunk, b)
        c = e - s
        pad = chunk - c
        uu = np.pad(users[s:e], (0, pad))
        gt = np.pad(eval_set.gt_items[s:e], ((0, pad), (0, 0)), constant_values=-1)
        gtc = np.pad(eval_set.gt_count[s:e], (0, pad))
        ex = np.pad(eval_set.exclude_items[s:e], ((0, pad), (0, 0)), constant_values=-1)
        exc = np.pad(eval_set.exclude_count[s:e], (0, pad))
        valid = np.arange(chunk) < c
        r_, h_, n_, m_ = _metrics_chunk(
            user_emb[t(uu).long()], item_emb, t(gt), t(gtc), t(ex), t(exc),
            t(valid), cfg.k,
        )
        rs += float(r_); hs += float(h_); ns += float(n_); cnt += float(m_)
    cnt = max(cnt, 1.0)
    return rs / cnt, hs / cnt / cfg.k, ns / cnt


def export_artifacts(
    params: LightGCNParams,
    data: LightGCNData,
    cfg: LightGCNConfig,
    artifact_dir: str,
    chunk: int = 1024,
) -> np.ndarray:
    """Top-``num_recommendations`` per user (every known interaction
    excluded) + the embedding tables (reference ``run_pipeline_lightgcn.py:
    211-238``). Returns the [U, R] recommendation matrix and writes
    ``lightgcn_output.npz`` and ``lightgcn_embeddings.npz``.

    As in the reference, the tables saved under ``users_emb_final`` /
    ``items_emb_final`` are the E⁰ tables."""
    os.makedirs(artifact_dir, exist_ok=True)
    eu, ei = data.all_edges
    dev = params.user_emb.device
    users = np.arange(data.num_users, dtype=np.int32)
    pos_items, pos_count = padded_user_items(users, eu.astype(np.int64), ei)
    out = np.zeros((data.num_users, cfg.num_recommendations), np.int32)
    for s in range(0, data.num_users, chunk):
        e = min(s + chunk, data.num_users)
        pad = chunk - (e - s)
        uu = torch.from_numpy(np.pad(users[s:e], (0, pad))).to(dev).long()
        ex = torch.from_numpy(
            np.pad(pos_items[s:e], ((0, pad), (0, 0)), constant_values=-1)
        ).to(dev)
        exc = torch.from_numpy(np.pad(pos_count[s:e], (0, pad))).to(dev)
        _, idx = auto_mips_topk(params.user_emb[uu], params.item_emb,
                                cfg.num_recommendations, ex, exc)
        out[s:e] = idx.cpu().numpy()[: e - s]

    np.savez_compressed(
        os.path.join(artifact_dir, "lightgcn_output.npz"), recommendations=out,
    )
    np.savez_compressed(
        os.path.join(artifact_dir, "lightgcn_embeddings.npz"),
        users_emb_final=params.user_emb[: data.num_users].cpu().numpy(),
        items_emb_final=params.item_emb[: data.num_items].cpu().numpy(),
    )
    return out
