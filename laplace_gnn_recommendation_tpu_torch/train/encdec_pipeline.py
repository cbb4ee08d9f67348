"""Hetero encoder-decoder training pipeline — the port of the JAX package's
``train/encdec_pipeline.py`` (the reference's ``run_pipeline.py:24-153`` +
``training.py:19-106``), on one device or on a mesh:

* a train step: embed → hetero SAGE → decode → masked BCE → gradients →
  one ``optax.adam`` update (``train/adam.Adam``) applied in place;
* eval every ``eval_every`` epochs: ``infer`` scores over the candidate
  label edges, per-user top-k (ties lowest slot first, as ``lax.top_k``),
  recall/precision against the user's positives;
* save-on-val-precision-inflection and periodic checkpoints, resume with a
  new draw stream, a non-finite epoch rolled back to copies of the last good
  state, truncation telemetry, and the final TEST pass.

Metric semantics are the JAX package's (top-k candidate *items* against
ground-truth items), not the reference's position-vs-id comparison.

Sampling stays on the host (numpy + the native library); each batch moves
to the card once, on the prefetch thread (``SubgraphBatch.to``). Dropout
masks come from one ``torch.Generator`` on the card seeded from
``cfg.seed``: a run is repeatable from its seed, but its draws are not the
JAX package's.

On a mesh (``mesh=``, called on every rank, JAX ``:65-120``): the feature
tables are row-sharded over ``model`` with cross-shard lookups
(``models/sage``), and a train step splits the label grid's rows over
``data`` — every rank samples the same host batch from the one seed, runs
the encoder whole and decodes its slice; the loss is its share of the whole
grid's mean, and the gradients are all-reduced over ``data`` before Adam.
Checkpoints are sharded when the model axis is > 1 (JAX ``:264-271``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs import Config
from ..data.link_pred_data import LinkPredData, create_samplers
from ..data.prefetch import prefetch
from ..data.sampler import SubgraphBatch, SubgraphSampler, parallel_epoch_batches
from ..models import sage
from ..ops.metrics import recall_precision_at_k, topk_hits
from ..ops.topk import top_k_lowest_first
from .adam import Adam
from ..parallel.collectives import all_reduce_, all_reduce_grads_
from ..parallel.mesh import DATA_AXIS, data_parts, mesh_from_config, model_parts
from .checkpoint import load_latest, save_state, tree_clone
from .lightgcn_pipeline import _finite_all, _resume_seed
from .reporting import (
    ContinousStatsTest,
    ContinousStatsTrain,
    ContinousStatsVal,
    Stats,
    report_results,
    setup_config,
)


def _model_inputs(data: LinkPredData) -> dict:
    return dict(
        user_features_float=data.user_features_float,
        item_features_float=data.item_features_float,
        item_extra_ids=data.item_extra_ids,
        extra_features=data.extra_features,
    )


def _model_mesh(mesh):
    """The mesh the model's lookups take: only one whose model axis is > 1."""
    return mesh if model_parts(mesh) > 1 else None


def make_train_step(cfg: Config, data: LinkPredData, tx, mesh=None):
    """One train step on the data's device (JAX ``:65-119``):
    ``step(params, bn_state, opt_state, batch, generator)`` runs the
    forward in train mode, takes the masked BCE's gradient w.r.t. every
    parameter and applies one ``tx`` update to ``params`` in place; it
    returns (params, new_bn_state, opt_state, loss), the loss a 0-d tensor
    on the card (not read back, so the step never waits for the card).

    With a ``mesh`` (called on every rank with the same batch): the label
    grid's rows split over ``data``, the gradients are all-reduced over it,
    and the loss returned is the whole grid's."""
    uf, itf = data.user_features, data.item_features
    extra = _model_inputs(data)
    dp = data_parts(mesh)

    def step(params: sage.SageModel, bn_state, opt_state, batch: SubgraphBatch,
             generator: Optional[torch.Generator]):
        for p in params.parameters():
            p.grad = None
        rows = mesh.batch_slice(batch.label_src.shape[0]) if dp > 1 else None
        logits, new_bn = sage.forward(params, bn_state, batch, uf, itf, cfg, train=True,
                                      generator=generator, mesh=_model_mesh(mesh), rows=rows,
                                      **extra)
        loss = sage.bce_loss(logits, batch, rows)
        loss.backward()
        loss = loss.detach()
        if dp > 1:
            all_reduce_grads_(params.parameters(), mesh)
            loss = all_reduce_(loss.clone(), mesh, DATA_AXIS)
        opt_state = tx.update_(sage.grad_tree(params), opt_state, sage.jax_tree(params))
        return params, new_bn, opt_state, loss

    return step


def make_eval_step(cfg: Config, data: LinkPredData, mesh=None):
    """``eval_step(params, bn_state, batch)`` → (recall, precision) of the
    batch as 0-d tensors (JAX ``:122-153``); on a ``mesh`` every rank
    scores the whole batch."""
    uf, itf = data.user_features, data.item_features
    extra = dict(_model_inputs(data), mesh=_model_mesh(mesh))

    @torch.no_grad()
    def eval_step(params, bn_state, batch: SubgraphBatch):
        batch = batch.to(uf.device) if not isinstance(batch.user_ids, torch.Tensor) else batch
        scores = sage.infer(params, bn_state, batch, uf, itf, cfg, **extra)
        k = min(cfg.k, scores.shape[1])
        _, pos = top_k_lowest_first(scores, k)
        topk_items = torch.gather(batch.label_item_global, 1, pos)
        # pad slots (INFER_PAD) are picked when a user has fewer than k
        # candidates: poison them so they cannot hit
        topk_valid = torch.gather(batch.label_mask, 1, pos)
        topk_items = torch.where(topk_valid, topk_items, torch.full_like(topk_items, -2))
        r = topk_hits(topk_items, batch.gt_items, batch.gt_count)
        return recall_precision_at_k(r, batch.gt_count, cfg.k)

    return eval_step


def test_with_sampler(
    cfg: Config,
    params,
    bn_state,
    sampler: SubgraphSampler,
    eval_step,
    break_at: Optional[int] = None,
    device=None,
) -> Tuple[float, float]:
    """Mean of the per-batch metrics over the sampler's users in order
    (reference ``test_with_dataloader``, ``training.py:85-106``); one read
    from the card at the end."""
    dev = device if device is not None else next(params.parameters()).device
    recalls, precisions = [], []
    for i, batch in enumerate(prefetch(sampler.epoch_batches(shuffle=False), buffer_size=1,
                                       transform=lambda b: b.to(dev))):
        if break_at and i == break_at:
            break
        r, p = eval_step(params, bn_state, batch)
        recalls.append(r)
        precisions.append(p)
    if not recalls:
        return 0.0, 0.0
    return float(torch.stack(recalls).mean()), float(torch.stack(precisions).mean())


def _state(params, bn_state, opt_state, epoch: int) -> dict:
    return {"params": sage.jax_tree(params), "bn_state": bn_state,
            "opt_state": opt_state, "epoch": int(epoch)}


def _feature_table_leaf(key: str) -> bool:
    """Leaves of an encoder-decoder state that are row-sharded feature
    tables (params and Adam moments) in a sharded checkpoint."""
    return "['embeddings']" in key


def run_pipeline(
    cfg: Config,
    data: LinkPredData,
    model_dir: str = "model/saved",
    log_fn=print,
    randomization: bool = True,
    return_state: bool = False,
    resume: bool = False,
    device="cuda",
    mesh=None,
    graph_store=None,
):
    """Full training run (JAX ``:176-407``, reference ``run_pipeline.py:
    24-153``) on the device of ``data``'s tables, which must be the
    ``device`` asked for (the card by default).

    ``graph_store`` selects the DB-backed sampler (the reference's
    ``config.neo4j`` switch): see ``data/link_pred_data.create_samplers``.

    Checkpoints (``model_dir/model_<epoch>.npz``, ``model_final.npz``) hold
    params, bn state, Adam state and epoch under the JAX package's keys, so
    ``resume`` also continues from a checkpoint the JAX pipeline wrote.

    ``mesh=None`` runs on one device unless ``cfg.mesh`` asks for a mesh or
    the process is one of several launched ranks. On a mesh (called on
    every rank) checkpoints are ``torch.distributed.checkpoint``
    directories when the model axis is > 1."""
    cfg.print()
    cfg.check_validity()
    dev = mesh.device if mesh is not None else resolve_device(device)
    if data.device.type != dev.type:
        raise ValueError(f"the data's tables are on {data.device}, not on {dev}; "
                         f"build them with device={dev.type!r}")
    dev = data.device
    if mesh is None:
        mesh = mesh_from_config(getattr(cfg, "mesh", None), device=dev)
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device}, the data on {dev}")
    ckpt_kw = dict(mesh=mesh, row_sharded=_feature_table_leaf)
    sharded_ckpt = model_parts(mesh) > 1
    wandb, cfg = setup_config("Fashion-Recomm-GNN", cfg.wandb_enabled, cfg)

    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    train_s, val_s, test_s = create_samplers(
        cfg, data, seed=cfg.seed, randomization=randomization, graph_store=graph_store,
    )
    params, bn_state = sage.init_sage_params(
        cfg, sage.get_feature_info(data.graph), float_dims=data.float_dims(),
        num_extra=data.num_extra, generator=gen, device=dev, mesh=mesh,
    )
    tx = Adam(cfg.learning_rate)
    opt_state = tx.init(sage.jax_tree(params))

    start_epoch = 0
    if resume:
        state, ver = load_latest(model_dir, _state(params, bn_state, opt_state, 0), **ckpt_kw)
        if ver is not None:
            sage.load_jax_tree_(params, state["params"])
            bn_state, opt_state = state["bn_state"], state["opt_state"]
            start_epoch = int(state["epoch"]) + 1
            # a draw stream of its own, not a replay of the first run's
            gen.manual_seed(_resume_seed(cfg.seed, start_epoch))
            log_fn(f"| Resuming from checkpoint (epoch {start_epoch})...")

    step = make_train_step(cfg, data, tx, mesh)
    eval_step = make_eval_step(cfg, data, mesh)
    to_dev = lambda b: b.to(dev)  # noqa: E731

    old_val_precision = -1.0
    val_recall = val_precision = 0.0
    epoch_loss = 0.0
    loss_curve: List[float] = []
    last_good = None  # copies of (params tree, bn_state, opt_state)

    for epoch in range(start_epoch, cfg.epochs):
        if cfg.num_workers > 1:
            # the reference DataLoader's num_workers as GIL-releasing sampler
            # threads; prefetch overlaps the device step with the stream
            feed = prefetch(
                parallel_epoch_batches(train_s, num_workers=cfg.num_workers, shuffle=True),
                buffer_size=cfg.num_workers, transform=to_dev,
            )
        else:
            feed = prefetch(train_s.epoch_batches(shuffle=True), buffer_size=1, transform=to_dev)
        losses = []
        for batch in feed:
            params, bn_state, opt_state, loss = step(params, bn_state, opt_state, batch, gen)
            losses.append(loss)
        epoch_loss = float(torch.stack(losses).double().mean()) if losses else float("nan")
        # a non-finite epoch rolls back to the last good epoch-end state; the
        # state itself is checked too (an inf Adam moment keeps the params
        # finite while it zeroes every later update)
        if not np.isfinite(epoch_loss) or not _finite_all(
            (sage.jax_tree(params), bn_state, opt_state), mesh
        ):
            if last_good is None:
                raise FloatingPointError(
                    f"non-finite loss in epoch {epoch} with no prior good state"
                )
            log_fn(f"TRAIN | epoch: {epoch} | non-finite loss — rolling back "
                   "to last good epoch state")
            # copies again: the update writes in place, and the snapshot must
            # survive repeated rollbacks
            p_tree, bn_state, opt_state = tree_clone(last_good)
            sage.load_jax_tree_(params, p_tree)
            continue
        last_good = tree_clone((sage.jax_tree(params), bn_state, opt_state))
        trunc = dict(getattr(train_s, "truncations", {}) or {})
        trunc_note = f" | truncations: {trunc}" if any(trunc.values()) else ""
        loss_curve.append(epoch_loss)
        log_fn(f"TRAIN | epoch: {epoch} | loss: {epoch_loss:.4f}{trunc_note}")
        report_results(ContinousStatsTrain(type="train", loss=epoch_loss, epoch=epoch),
                       wandb, final=False)

        if epoch % cfg.eval_every == 0 and epoch != 0:
            val_recall, val_precision = test_with_sampler(
                cfg, params, bn_state, val_s, eval_step, cfg.evaluate_break_at, dev
            )
            log_fn(f"VAL   | epoch: {epoch} | recall: {val_recall:.4f} "
                   f"| precision: {val_precision:.4f}")
            # save-on-generalization-inflection (run_pipeline.py:104-112)
            if cfg.save_model:
                if val_precision >= old_val_precision:
                    old_val_precision = val_precision
                else:
                    log_fn("| Saving Best Generalized Model...")
                    save_state(os.path.join(model_dir, "model_final"),
                               _state(params, bn_state, opt_state, epoch),
                               sharded=sharded_ckpt, **ckpt_kw)
                    old_val_precision = -1.0
            report_results(
                ContinousStatsVal(type="val", recall_val=val_recall,
                                  precision_val=val_precision, epoch=epoch),
                wandb, final=False,
            )

        if cfg.save_model and epoch % max(1, int(cfg.epochs * cfg.save_every)) == 0:
            save_state(os.path.join(model_dir, f"model_{epoch:03d}"),
                       _state(params, bn_state, opt_state, epoch),
                       sharded=sharded_ckpt, **ckpt_kw)

    test_recall, test_precision = test_with_sampler(
        cfg, params, bn_state, test_s, eval_step, cfg.evaluate_break_at, dev
    )
    log_fn(f"TEST  | recall: {test_recall:.4f} | precision: {test_precision:.4f}")
    report_results(
        ContinousStatsTest(type="test", recall_test=test_recall, precision_test=test_precision),
        wandb, final=True,
    )
    agg: dict = {}
    for s in (train_s, val_s, test_s):
        for k_, v in (getattr(s, "truncations", {}) or {}).items():
            agg[k_] = agg.get(k_, 0) + int(v)
    stats = Stats(
        loss=epoch_loss,
        recall_val=val_recall,
        recall_test=test_recall,
        precision_val=val_precision,
        precision_test=test_precision,
        truncations=agg,
        loss_curve=loss_curve,
    )
    if return_state:
        return stats, params, bn_state
    return stats
