"""LightGCN training / eval / artifact-export pipeline — the port of the JAX
package's ``train/lightgcn_pipeline.py`` (the reference's
``run_pipeline_lightgcn.py:20-242``):

* a train step samples a BPR batch on the card (``ops/sampling.py``), runs
  the K-hop forward, the BPR loss and its gradient — through kernel A and
  the self-adjoint loop on the kernel tier, 2·K launches forward and 2·K
  backward — and one Adam update under the staircase 0.95 decay
  (``train/adam.py``);
* eval = BPR loss over the eval split + batched recall/precision/NDCG@k with
  train-edge exclusion (reference ``run_pipeline_lightgcn.py:20-73``);
* ``train`` keeps the JAX loop's non-finite rollback, checkpoint/resume,
  best-val selection and lazily built eval operands;
* artifact export: per-user top-``num_recommendations`` item ids + the
  embedding tables (reference ``run_pipeline_lightgcn.py:211-238``).

Scoring embeddings: the reference's metrics and export consume the **E⁰**
tables (``eval_embeddings="e0"``, the default); ``"final"`` scores with the
propagated embeddings, as in the LightGCN paper.

Random draws come from one ``torch.Generator`` on the data's card, seeded
from ``cfg.seed``: a run is repeatable from its seed, but its draws are not
the JAX package's (``jax.random`` keys).

On a mesh (``mesh=``, called on every rank) the node counts pad to divide
the ``model`` axis after init, the E⁰ tables and their Adam moments are
row-sharded over it, propagation is the sharded tier (``auto`` takes it
when the model axis is > 1), lookups of table rows go through the
cross-shard exchange (``ops/embedding``), and eval and export score through
the distributed top-k (``ops/topk.sharded_mips_topk``) with the pad tail
masked. Every rank draws the global BPR batch from the one seed and keeps
its ``data`` slice; the loss is the mean over the global batch and the
table gradients are all-reduced over ``data`` before Adam, so a run on any
mesh follows the single-device run.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs import LightGCNConfig
from ..data.graph import BipartiteGraph
from ..data.lightgcn_data import EvalSet, LightGCNData, padded_user_items
from ..models.lightgcn import LightGCNParams, bpr_loss, init_lightgcn, lightgcn_forward
from ..ops.metrics import topk_hits
from ..ops.sampling import sample_bpr_batch, structured_negative_sampling
from ..ops.embedding import shard_table, sharded_embedding_lookup
from ..ops.topk import auto_mips_topk, masked_topk, sharded_mips_topk
from ..parallel.collectives import (
    all_gather_dim0,
    all_reduce_,
    all_reduce_world_,
    barrier,
    sync_grads,
)
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    data_parts,
    mesh_from_config,
    model_parts,
    shard_rows_pad,
)
from ..utils.profiling import tracer
from .adam import StaircaseAdam
from .checkpoint import load_latest, save_state, tree_clone, tree_leaves_with_path
from .reporting import Stats


# Node-table size from which the blocked tier gathers in bf16 (the JAX
# package's ``train/lightgcn_pipeline.BF16_GATHER_ROWS``).
BF16_GATHER_ROWS = 1 << 19


def uses_bf16_gather(graph: BipartiteGraph) -> bool:
    """The JAX ``_maybe_bf16`` rule: the blocked tier gathers in bf16 when a
    node table has at least ``BF16_GATHER_ROWS`` rows."""
    return max(graph.num_users, graph.num_items) >= BF16_GATHER_ROWS


def maybe_dense(cfg: LightGCNConfig, graph: BipartiteGraph):
    """The single-device operand ``auto`` takes (JAX ``:60-73``): the dense
    tier where Ã and Ãᵀ fit ``cfg.dense_bytes_budget``, else kernel A's
    operand in the gather mode of the JAX blocked tier (``uses_bf16_gather``),
    else (no edges) the graph itself."""
    from ..ops.spmm_dense import DenseAdjacency, dense_fits
    from ..ops.spmm_pallas import PallasGraph

    if cfg.dense_bytes_budget and dense_fits(
        graph.num_users, graph.num_items, cfg.dense_bytes_budget
    ):
        return DenseAdjacency.from_graph(graph)
    if graph.num_edges > 0:
        return PallasGraph.from_graph(graph, width=cfg.hidden_layer_size,
                                      gather_bf16=uses_bf16_gather(graph))
    return graph


def select_propagation(cfg: LightGCNConfig, graph: BipartiteGraph, mesh=None):
    """Propagation operand for ``lightgcn_forward`` (``cfg.propagation``,
    JAX ``:76-122``).

    ``sharded``, and ``auto`` when the mesh's model axis is > 1, give this
    rank's :class:`ShardedBipartiteGraph` (kernel A per shard); with a model
    axis > 1 no other tier applies, since the tables are row blocks.

    ``plain`` is the numerical reference (``index_add_``); ``dense`` the
    dense tier; ``pallas`` and ``blocked`` — two TPU layouts of one
    contraction — both map onto the segment-sum kernel, ``blocked`` in the
    bf16-gather mode where the JAX package's blocked tier takes it
    (``uses_bf16_gather``). ``auto`` follows the JAX rule on the card and on
    the CPU alike (:func:`maybe_dense`)."""
    from ..ops.spmm_dense import DenseAdjacency
    from ..ops.spmm_pallas import PallasGraph

    from ..ops.spmm_sharded import ShardedBipartiteGraph

    mode = getattr(cfg, "propagation", "auto")
    width = cfg.hidden_layer_size
    if mode == "sharded" or (mode == "auto" and model_parts(mesh) > 1):
        if mesh is None:
            raise ValueError("sharded propagation needs a mesh")
        return ShardedBipartiteGraph.from_graph(graph, mesh, width=width)
    if model_parts(mesh) > 1:
        raise ValueError(f"propagation={mode!r} runs on whole tables; a model axis > 1 "
                         "takes 'sharded' or 'auto'")
    if mode == "plain":
        return graph
    if mode == "pallas":
        return PallasGraph.from_graph(graph, width=width)
    if mode == "dense":
        return DenseAdjacency.from_graph(graph)
    if mode == "blocked":
        return PallasGraph.from_graph(graph, width=width,
                                      gather_bf16=uses_bf16_gather(graph))
    if mode != "auto":
        raise ValueError(f"unknown propagation mode {mode!r}")
    return maybe_dense(cfg, graph)


def _user_row_ptr(g: BipartiteGraph) -> torch.Tensor:
    """CSR row pointers over the user-major edge order (JAX ``:53-57``)."""
    return torch.cat([
        torch.zeros(1, dtype=torch.int64, device=g.device),
        torch.cumsum(g.user_deg.long(), 0),
    ])


def _rows(table: torch.Tensor, idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """``table[idx]`` of a whole table, or of one sharded over the mesh's
    model axis (``table`` its row block; the cross-shard lookup)."""
    if model_parts(mesh) > 1:
        return sharded_embedding_lookup(mesh, table, idx)
    return table[idx]


def _bpr_share(uf_u, u0_u, itf_p, it0_p, itf_n, it0_n, lambda_val: float, variant: str,
               n_global: int) -> torch.Tensor:
    """This data slice's share of ``bpr_loss`` over a batch of ``n_global``
    rows: its rank terms summed over ``n_global``, plus its regulariser. The
    shares of all slices sum to the global loss."""
    reg = lambda_val * (u0_u.pow(2).sum() + it0_p.pow(2).sum() + it0_n.pow(2).sum())
    diff = (uf_u * itf_p).sum(-1) - (uf_u * itf_n).sum(-1)
    term = F.softplus(diff) if variant == "legacy" else F.logsigmoid(diff)
    return -term.sum() / n_global + reg


def _on_device(graph: BipartiteGraph, device) -> torch.device:
    """The graph's device, which must be the (resolved) ``device`` asked for."""
    dev = resolve_device(device)
    if graph.device.type != dev.type:
        raise ValueError(f"the data's graphs are on {graph.device}, not on {dev}; "
                         f"build them with device={dev.type!r}")
    return graph.device


def make_train_step(
    cfg: LightGCNConfig,
    graph: BipartiteGraph,
    max_degree: int,
    prop_graph=None,
    device="cuda",
    mesh=None,
):
    """One train step over ``graph`` (JAX ``:140-205``): returns
    (``step``, ``tx``). ``step(params, opt_state, generator)`` draws a BPR
    batch, propagates over ``prop_graph`` (default ``graph``), takes the
    loss's gradient w.r.t. both E⁰ tables and applies one Adam update to
    ``params`` in place; it returns (params, opt_state, loss), the loss a
    0-d tensor on the card (not read back, so the step never waits for the
    card). ``tx`` is the :class:`StaircaseAdam` whose ``init`` makes the
    first ``opt_state``. The step's phases are host spans of
    ``utils/profiling.tracer``: ``bpr.sample``, ``bpr.grad`` (forward, loss
    and gradient) and ``adam``.

    With a ``mesh`` (called on every rank, ``params`` this rank's tables):
    every rank draws the global batch from its generator (one seed on every
    rank) and keeps its ``data`` slice; its share of the global-batch loss
    backpropagates through the cross-shard lookups and the sharded
    propagation, the table gradients are all-reduced over ``data``
    (``sync_grads``), and the returned loss is the global one."""
    _on_device(graph, device)
    tx = StaircaseAdam(cfg.learning_rate, cfg.lr_decay_every)
    row_ptr = _user_row_ptr(graph)
    prop = graph if prop_graph is None else prop_graph
    dp = data_parts(mesh)

    def step(params: LightGCNParams, opt_state, generator: torch.Generator):
        with tracer.span("bpr.sample"):
            u, pos, neg = (x.long() for x in sample_bpr_batch(
                generator, graph.edge_user, graph.edge_item, graph.num_edges, cfg.batch_size,
                row_ptr, graph.edge_item, graph.num_items, max_degree,
            ))
            n = u.shape[0]
            if dp > 1:
                sl = mesh.batch_slice(n)
                u, pos, neg = u[sl], pos[sl], neg[sl]
        with tracer.span("bpr.grad"):
            # leaves that share the tables' storage: the gradient is taken
            # w.r.t. them, and the update then writes the tables in place
            e0 = LightGCNParams(params.user_emb.detach().requires_grad_(),
                                params.item_emb.detach().requires_grad_())
            uf, u0, itf, it0 = lightgcn_forward(
                LightGCNParams(sync_grads(e0.user_emb, mesh), sync_grads(e0.item_emb, mesh)),
                prop, cfg.num_iterations)
            rows = (_rows(uf, u, mesh), _rows(u0, u, mesh), _rows(itf, pos, mesh),
                    _rows(it0, pos, mesh), _rows(itf, neg, mesh), _rows(it0, neg, mesh))
            if dp > 1:
                loss = _bpr_share(*rows, cfg.Lambda, cfg.bpr_variant, n)
            else:
                loss = bpr_loss(*rows, cfg.Lambda, cfg.bpr_variant)
            grads = LightGCNParams(*torch.autograd.grad(loss, (e0.user_emb, e0.item_emb)))
        with tracer.span("adam"):
            opt_state = tx.update_(grads, opt_state, params)
        loss = loss.detach()
        if dp > 1:
            loss = all_reduce_(loss.clone(), mesh, DATA_AXIS)
        return params, opt_state, loss

    return step, tx


@torch.no_grad()
def eval_loss(
    cfg: LightGCNConfig,
    params: LightGCNParams,
    eval_graph: BipartiteGraph,
    eval_set: EvalSet,
    generator: torch.Generator,
    max_degree: int,
    prop_graph=None,
    mesh=None,
) -> torch.Tensor:
    """BPR loss over every edge of the eval split with one sampled negative
    each (JAX ``:208-272``; reference ``run_pipeline_lightgcn.py:36-67``):
    the rank term is the mean over the split's edges, the regulariser
    λ·Σ over all of them. The forward runs over ``prop_graph`` (default
    ``eval_graph``). The JAX package pads the edges to multiples of 4096
    and masks the pads out; the port needs no padding. On a ``mesh`` whose
    model axis is > 1 the rows come through the cross-shard lookup, and
    every rank computes the whole loss."""
    dev = eval_graph.device
    e = len(eval_set.edge_user)
    eu = torch.from_numpy(eval_set.edge_user.astype(np.int64)).to(dev)
    ei = torch.from_numpy(eval_set.edge_item.astype(np.int64)).to(dev)
    neg = structured_negative_sampling(
        generator, eu, _user_row_ptr(eval_graph), eval_graph.edge_item,
        eval_graph.num_items, max_degree,
    ).long()
    uf, u0, itf, it0 = lightgcn_forward(
        params, eval_graph if prop_graph is None else prop_graph, cfg.num_iterations
    )
    uf_u, itf_i, itf_n = _rows(uf, eu, mesh), _rows(itf, ei, mesh), _rows(itf, neg, mesh)
    reg = cfg.Lambda * (_rows(u0, eu, mesh) ** 2 + _rows(it0, ei, mesh) ** 2
                        + _rows(it0, neg, mesh) ** 2).sum()
    diff = (uf_u * itf_i).sum(-1) - (uf_u * itf_n).sum(-1)
    if cfg.bpr_variant == "legacy":
        rank = -F.softplus(diff).sum() / max(e, 1)
    else:
        rank = -F.logsigmoid(diff).sum() / max(e, 1)
    return rank + reg


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


@torch.no_grad()
def get_metrics(
    params: LightGCNParams,
    cfg: LightGCNConfig,
    eval_set: EvalSet,
    graph_for_final=None,
    eval_embeddings: str = "e0",
    chunk: int = 1024,
    mesh=None,
    num_valid_items=None,
) -> Tuple[float, float, float]:
    """recall/precision/ndcg@k over an eval split, chunked over users
    (``utils/metrics_lightgcn.py:79-122`` semantics: scores = user·itemᵀ,
    train edges masked out, topk(k), hits vs the split's ground truth).
    ``graph_for_final`` is the propagation operand for ``"final"``.

    On a ``mesh`` whose model axis is > 1 the tables are row blocks: the
    users' rows come through the cross-shard lookup and the scoring is the
    distributed top-k (JAX ``_sharded_metrics_chunk``, ``:320``), with item
    ids at or past ``num_valid_items`` (the pad tail) masked."""
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

    sharded = model_parts(mesh) > 1
    nvalid = int(num_valid_items if num_valid_items is not None
                 else item_emb.shape[0] * model_parts(mesh))
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
        uvec = _rows(user_emb, t(uu).long(), mesh)
        if sharded:
            _, topk_items = sharded_mips_topk(mesh, uvec, item_emb, cfg.k, t(ex), t(exc),
                                              num_valid_items=nvalid)
            r_, h_, n_, m_ = _metrics_from_topk(topk_items, t(gt), t(gtc), t(valid), cfg.k)
        else:
            r_, h_, n_, m_ = _metrics_chunk(uvec, item_emb, t(gt), t(gtc), t(ex), t(exc),
                                            t(valid), cfg.k)
        rs += float(r_); hs += float(h_); ns += float(n_); cnt += float(m_)
    cnt = max(cnt, 1.0)
    return rs / cnt, hs / cnt / cfg.k, ns / cnt


def evaluation(
    cfg: LightGCNConfig,
    params: LightGCNParams,
    eval_graph: BipartiteGraph,
    eval_set: EvalSet,
    generator: torch.Generator,
    max_degree: int,
    eval_embeddings: str = "e0",
    prop_graph=None,
    metrics_prop_graph=None,
    mesh=None,
    num_valid_items=None,
) -> Tuple[float, float, float, float]:
    """(loss, recall, precision, ndcg) — JAX ``:420-454``, reference
    ``run_pipeline_lightgcn.py:20-73``. The loss propagates over the eval
    split's own adjacency (``prop_graph``); the metrics under
    ``eval_embeddings="final"`` over ``metrics_prop_graph`` — callers pass
    the TRAIN operand, since the eval split's edges are the targets. ``mesh``
    and ``num_valid_items`` as in :func:`get_metrics`."""
    loss = float(eval_loss(cfg, params, eval_graph, eval_set, generator, max_degree,
                           prop_graph, mesh))
    recall, precision, ndcg = get_metrics(
        params, cfg, eval_set,
        graph_for_final=(
            metrics_prop_graph if metrics_prop_graph is not None
            else (prop_graph if prop_graph is not None else eval_graph)
        ),
        eval_embeddings=eval_embeddings,
        mesh=mesh, num_valid_items=num_valid_items,
    )
    return loss, recall, precision, ndcg


def export_artifacts(
    params: LightGCNParams,
    data: LightGCNData,
    cfg: LightGCNConfig,
    artifact_dir: str,
    chunk: int = 1024,
    mesh=None,
) -> np.ndarray:
    """Top-``num_recommendations`` per user (every known interaction
    excluded) + the embedding tables (reference ``run_pipeline_lightgcn.py:
    211-238``). Returns the [U, R] recommendation matrix and writes
    ``lightgcn_output.npz`` and ``lightgcn_embeddings.npz``.

    As in the reference, the tables saved under ``users_emb_final`` /
    ``items_emb_final`` are the E⁰ tables, at the true node counts.

    On a ``mesh`` (called on every rank) whose model axis is > 1, ``params``
    are row blocks of tables padded to divide it: the sweep runs the
    distributed top-k over the pad-masked catalog, and rank 0 writes the
    files (the others wait for them)."""
    sharded = model_parts(mesh) > 1
    multi = mesh is not None and mesh.device_mesh is not None
    if not multi or mesh.is_coordinator:
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
        if sharded:
            _, idx = sharded_mips_topk(mesh, _rows(params.user_emb, uu, mesh), params.item_emb,
                                       cfg.num_recommendations, ex, exc,
                                       num_valid_items=data.num_items)
        else:
            _, idx = auto_mips_topk(params.user_emb[uu], params.item_emb,
                                    cfg.num_recommendations, ex, exc)
        out[s:e] = idx.cpu().numpy()[: e - s]

    user_emb, item_emb = params.user_emb, params.item_emb
    if sharded:
        user_emb = all_gather_dim0(user_emb.detach(), mesh, MODEL_AXIS)
        item_emb = all_gather_dim0(item_emb.detach(), mesh, MODEL_AXIS)
    if not multi or mesh.is_coordinator:
        np.savez_compressed(
            os.path.join(artifact_dir, "lightgcn_output.npz"), recommendations=out,
        )
        np.savez_compressed(
            os.path.join(artifact_dir, "lightgcn_embeddings.npz"),
            users_emb_final=user_emb[: data.num_users].cpu().numpy(),
            items_emb_final=item_emb[: data.num_items].cpu().numpy(),
        )
    barrier(mesh)
    return out


def _finite_all(tree, mesh=None) -> bool:
    """Whether every float tensor of ``tree`` is finite: one reduction, one
    read from the card (the JAX ``train/encdec_pipeline._finite_all``). On a
    mesh of several ranks the answer is every rank's (one all-reduce), so
    all ranks take the same branch."""
    flags = [torch.isfinite(x).all() for _, x in tree_leaves_with_path(tree)
             if isinstance(x, torch.Tensor) and x.is_floating_point()]
    ok = torch.stack(flags).all() if flags else torch.ones((), dtype=torch.bool)
    if mesh is None or mesh.device_mesh is None:
        return bool(ok)
    import torch.distributed as dist

    ok = ok.to(device=mesh.device, dtype=torch.float32).reshape(1)
    return bool(all_reduce_world_(ok, mesh, dist.ReduceOp.MIN)[0] > 0)


def _table_leaf(key: str) -> bool:
    """Leaves of a LightGCN state that are row-sharded tables (params and
    Adam moments) in a sharded checkpoint."""
    return key.endswith(".user_emb") or key.endswith(".item_emb")


def _resume_seed(seed: int, start_it: int) -> int:
    """Seed of the draw stream after a resume at ``start_it``: a stream of
    its own, not a replay of the first run's (JAX ``fold_in``, ``:640-641``)."""
    return int(np.random.SeedSequence([seed, start_it]).generate_state(1)[0])


def train(
    cfg: LightGCNConfig,
    data: LightGCNData,
    export: bool = True,
    eval_embeddings: str = "e0",
    log_fn=print,
    device="cuda",
    mesh=None,
) -> Stats:
    """Full training loop — JAX ``:529-780``, reference
    ``run_pipeline_lightgcn.py:76-232``, on the device of the data's graphs,
    which must be the ``device`` asked for (the card by default).

    ``mesh=None`` runs on one device, unless ``cfg.mesh`` asks for a mesh or
    the process is one of several launched ranks: then the mesh is built
    from ``cfg.mesh`` over every rank (JAX ``:548-558``). On a mesh (see the
    module's docstring) ``train`` is called on every rank; the node counts
    pad to divide the model axis after init, so the true rows equal the
    single-device run's (JAX ``:565-585``), and checkpoints are sharded when
    the model axis is > 1.

    Every ``eval_every`` steps: a non-finite loss, params or optimizer state
    rolls back to a copy taken at the last finite eval point (the retried
    steps draw new batches); else the val split is evaluated. Every
    ``checkpoint_every`` steps a finite (params, opt_state) is saved under
    ``artifact_dir/lightgcn_ckpt``; ``resume`` continues from the newest one
    with a new draw stream. ``select_best_val`` reports test metrics from
    the best val recall seen. ``Stats.loss_curve`` holds every step's loss.
    """
    cfg.print()
    dev = _on_device(data.train_graph, mesh.device if mesh is not None else device)
    if mesh is None:
        mesh = mesh_from_config(getattr(cfg, "mesh", None), device=dev)
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device}, the data on {dev}")
    parts = model_parts(mesh)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = init_lightgcn(data.num_users, data.num_items, cfg.hidden_layer_size,
                           generator=gen, device=dev)
    u_pad, i_pad = data.num_users, data.num_items
    if parts > 1:
        # pad after init (the true rows are the single-device run's), then
        # keep this rank's row blocks
        u_pad, i_pad = shard_rows_pad(u_pad, mesh), shard_rows_pad(i_pad, mesh)
        params = LightGCNParams(
            user_emb=shard_table(mesh, F.pad(params.user_emb, (0, 0, 0, u_pad - data.num_users))),
            item_emb=shard_table(mesh, F.pad(params.item_emb, (0, 0, 0, i_pad - data.num_items))),
        )

    def max_degree(g: BipartiteGraph) -> int:
        return max(1, int(g.user_deg.max().item())) if g.num_users else 1

    max_deg_train = max_degree(data.train_graph)
    # one bound for both eval splits, as in the JAX package; it only has to
    # be at least each split's true maximum
    max_deg_eval = max(max_degree(data.val_graph), max_degree(data.test_graph))

    def prop_operand(g: BipartiteGraph):
        if parts > 1 and (u_pad != g.num_users or i_pad != g.num_items):
            # the same edges (so the same degrees and weights) over the
            # padded node counts; only its host arrays are read
            g = BipartiteGraph.from_edges(*g.edges_host(), u_pad, i_pad, device="cpu")
        return select_propagation(cfg, g, mesh)

    train_prop = prop_operand(data.train_graph)
    # val/test operands are built at their first eval (host plan build and
    # card memory are wasted when eval_every is sparse)
    _prop_cache: dict = {}

    def eval_prop(name: str, graph: BipartiteGraph):
        if name not in _prop_cache:
            _prop_cache[name] = prop_operand(graph)
        return _prop_cache[name]

    step_fn, tx = make_train_step(cfg, data.train_graph, max_deg_train,
                                  prop_graph=train_prop, device=dev, mesh=mesh)
    opt_state = tx.init(params)

    ckpt_dir = os.path.join(cfg.artifact_dir, "lightgcn_ckpt")
    ckpt_kw = dict(mesh=mesh, row_sharded=_table_leaf)
    start_it = 0
    if cfg.resume:
        state, ver = load_latest(ckpt_dir, {"params": params, "opt_state": opt_state},
                                 **ckpt_kw)
        if ver is not None:
            params, opt_state = state["params"], state["opt_state"]
            start_it = ver + 1
            gen.manual_seed(_resume_seed(cfg.seed, start_it))
            log_fn(f"| Resuming from checkpoint (iteration {start_it})...")

    def evaluate(name, graph, eval_set):
        return evaluation(
            cfg, params, graph, eval_set, gen, max_deg_eval, eval_embeddings,
            prop_graph=eval_prop(name, graph), metrics_prop_graph=train_prop,
            mesh=mesh, num_valid_items=data.num_items,
        )

    train_loss = torch.zeros((), device=dev)
    losses = []
    recall = precision = 0.0
    best_recall, best_params, last_evaled = -1.0, None, -1
    last_good = None  # copies of (params, opt_state) at the last finite eval point
    for it in range(start_it, cfg.epochs):
        params, opt_state, train_loss = step_fn(params, opt_state, gen)
        losses.append(train_loss)

        if cfg.checkpoint_every and it % cfg.checkpoint_every == 0 and it > start_it:
            # never persist a poisoned state: resume loads the newest checkpoint
            if np.isfinite(float(train_loss)) and _finite_all((params, opt_state), mesh):
                save_state(os.path.join(ckpt_dir, f"model_{it}"),
                           {"params": params, "opt_state": opt_state},
                           sharded=parts > 1, **ckpt_kw)
            else:
                log_fn(f"| skipping checkpoint at iter {it}: non-finite state")

        if it % cfg.eval_every == 0:
            # checked on params AND optimizer state: an inf second moment
            # keeps the params finite while it zeroes every later update
            if not np.isfinite(float(train_loss)) or not _finite_all((params, opt_state), mesh):
                if last_good is None:
                    raise FloatingPointError(
                        f"non-finite loss {float(train_loss)} at iter {it} "
                        "before any finite eval point"
                    )
                # hand out copies: the update writes the tables in place, and
                # the snapshot must survive repeated rollbacks
                params, opt_state = tree_clone(last_good)
                log_fn(f"| non-finite loss at iter {it}: rolled back to the "
                       "last finite eval point")
                continue
            last_good = tree_clone((params, opt_state))
            val_loss, recall, precision, ndcg = evaluate("val", data.val_graph, data.val_set)
            last_evaled = it
            if recall > best_recall:
                best_recall, best_params = recall, (tree_clone(params), precision)
            log_fn(
                f"[Iter {it}/{cfg.epochs}] train_loss: {float(train_loss):.5f}, "
                f"val_loss: {val_loss:.5f}, val_recall@{cfg.k}: {recall:.6f}, "
                f"val_precision@{cfg.k}: {precision:.6f}, val_ndcg@{cfg.k}: {ndcg:.6f}"
            )

    if cfg.select_best_val:
        if last_evaled != cfg.epochs - 1:  # the last iterate was never scored
            _, recall, precision, _ = evaluate("val", data.val_graph, data.val_set)
            if recall > best_recall:
                best_recall, best_params = recall, (params, precision)
        if best_params is not None and best_params[0] is not params:
            log_fn(f"| select_best_val: using checkpoint with val recall "
                   f"{best_recall:.6f} (final iterate: {recall:.6f})")
        if best_params is not None:
            params, precision = best_params
            recall = best_recall

    test_loss, test_recall, test_precision, test_ndcg = evaluate(
        "test", data.test_graph, data.test_set)
    log_fn(
        f"[test_loss: {test_loss:.5f}, test_recall@{cfg.k}: {test_recall:.5f}, "
        f"test_precision@{cfg.k}: {test_precision:.5f}, test_ndcg@{cfg.k}: {test_ndcg:.5f}]"
    )

    if export:
        export_artifacts(params, data, cfg, cfg.artifact_dir, mesh=mesh)

    return Stats(
        loss=float(train_loss),
        recall_val=recall,
        recall_test=test_recall,
        precision_val=precision,
        precision_test=test_precision,
        params=params if cfg.return_params else None,
        loss_curve=torch.stack(losses).tolist() if losses else [],
    )
