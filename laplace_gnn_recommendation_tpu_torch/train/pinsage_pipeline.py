"""PinSAGE training and evaluation — the port of the JAX package's
``train/pinsage_pipeline.py`` (reference ``pinsage/model.py:36-134`` and
``pinsage/evaluation.py:18-73``), on one device:

* epochs of (head, tail, neg) margin-loss batches over random-walk blocks,
  sampled on the host and moved to the card on a prefetch thread, through
  :func:`make_train_step`: Adam
  (``train/adam.Adam``, optax's) over every parameter, or with
  ``sparse_embedding`` Adam over the rest and the lazy row-sparse Adam of
  ``train/optim.py`` on the id table and the item biases,
* eval: embed every item through the block sampler, then latest-item
  nearest-neighbour retrieval per user with the user's train items
  excluded, scored as HITS@k (the share of users whose top k holds a
  ground-truth item),
* epoch checkpoints ``pinsage_<epoch>`` (npz, the JAX package's keys) and
  resume in bounded legs.

Dropout draws from one ``torch.Generator`` on the device seeded from
``cfg.seed``; a run repeats from its seed, but its draws are not the JAX
package's.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.pinsage_data import PinSAGEData, PinSAGESampler, build_pinsage_data
from ..data.prefetch import prefetch
from ..models import pinsage as M
from ..ops.topk import masked_topk
from .adam import Adam
from .checkpoint import load_latest, save_state, tree_grads
from .lightgcn_pipeline import _resume_seed
from .optim import init_sparse_adam_state, sparse_rows_adam_update


@dataclass
class PinSAGEConfig:
    """Defaults of reference ``run_pinsage.py:6-37`` / ``pinsage/model.py:137-160``."""

    random_walk_length: int = 2
    random_walk_restart_prob: float = 0.5
    num_random_walks: int = 10
    num_neighbors: int = 3
    num_layers: int = 2
    hidden_dims: int = 16
    batch_size: int = 32
    num_epochs: int = 10
    batches_per_epoch: int = 20000
    lr: float = 3e-5
    k: int = 10
    seed: int = 0
    sparse_embedding: bool = False
    """Lazy row-sparse Adam on the id-embedding table + biases (the
    reference's SparseAdam variant, ``pinsage/model_sparse.py:104-127``):
    only the batch's touched rows move."""


@dataclass
class MaskedState:
    """optax ``masked``'s state: the inner optimizer's state over the params
    it updates (the sparse path's Adam leaves out the id table and biases)."""

    inner_state: tuple


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("a multi-device mesh comes with the multi-GPU slice")


def embed_all_items(
    cfg: PinSAGEConfig,
    params: M.PinSAGEModel,
    data: PinSAGEData,
    sampler: PinSAGESampler,
    item_features: torch.Tensor,
    item_features_float: Optional[torch.Tensor],
) -> np.ndarray:
    """h_item [num_items, hidden] for every item through block sampling in
    batches (reference ``pinsage/model.py:121-132`` with ``collate_test``), on
    the device of ``item_features``; one read back at the end. The chunks are
    sampled on a prefetch thread in the JAX package's order."""
    dev = item_features.device
    reprs = torch.zeros((data.num_items, params.proj.id_table.shape[1]), device=dev)
    bs = sampler.dst_budget[0]

    def chunks():
        for s in range(0, data.num_items, bs):
            blocks, _ = sampler.sample_blocks(np.arange(s, min(s + bs, data.num_items)))
            yield s, blocks

    with torch.no_grad():
        for s, blocks in prefetch(chunks(), buffer_size=2,
                                  transform=lambda c: (c[0], [b.to(dev) for b in c[1]])):
            n = min(bs, data.num_items - s)
            h = M.get_repr(params, blocks, item_features, item_features_float, train=False)
            reprs[s:s + n] = h[:n]
    return reprs.cpu().numpy()


def hits_at_k(
    data: PinSAGEData,
    h_item,
    k: int,
    split: str = "val",
    batch_size: int = 512,
    mesh=None,
    user_cap: Optional[int] = None,
    device="cuda",
) -> float:
    """LatestNNRecommender + HITS@k (reference ``pinsage/evaluation.py:8-73``):
    each user's items ranked by similarity to their latest train item, with
    the train items excluded; a hit when a top-k item is in the split's
    ground truth. Users without ground truth or a train item are left out;
    ``user_cap`` keeps that many, evenly spaced. Scores on ``device``; the
    tail chunk is as short as it is."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    gt = data.val_items if split == "val" else data.test_items
    h = torch.as_tensor(np.asarray(h_item, np.float32)).to(dev)
    has_gt = np.fromiter((len(x) > 0 for x in gt), bool, count=data.num_users)
    users = np.flatnonzero(has_gt & (data.latest_item_per_user >= 0))
    if user_cap is not None and len(users) > user_cap:
        # deterministic evenly spaced cap, as the JAX function takes it
        users = users[np.linspace(0, len(users) - 1, user_cap).astype(np.int64)]
    csr = data.user_csr
    deg = csr.degrees
    max_deg = int(deg[users].max()) if len(users) else 1
    slots = np.arange(max_deg)
    hits = []
    for s in range(0, len(users), batch_size):
        chunk = users[s: s + batch_size]
        cnt = deg[chunk]
        pos = csr.row_ptr[chunk][:, None] + slots[None, :]
        inside = slots[None, :] < cnt[:, None]
        excl = np.where(inside, csr.cols[np.where(inside, pos, 0)], -1)
        latest = torch.from_numpy(data.latest_item_per_user[chunk].astype(np.int64)).to(dev)
        scores = h.index_select(0, latest) @ h.T
        _, topk = masked_topk(scores, k, torch.from_numpy(excl.astype(np.int64)).to(dev),
                              torch.from_numpy(cnt.astype(np.int64)).to(dev))
        topk = topk.cpu().numpy()
        for row, u in enumerate(chunk):
            hits.append(bool(np.isin(topk[row], gt[u]).any()))
    return float(np.mean(hits)) if hits else 0.0


def make_train_step(
    cfg: PinSAGEConfig,
    params: M.PinSAGEModel,
    item_features: torch.Tensor,
    item_features_float: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
):
    """One train step on the device of ``params``: (step, state).
    ``step(batch, src_mask, dst_mask)`` takes a batch on that device and its
    outermost src and innermost dst masks as host arrays, runs the margin loss in train mode (dropout from ``generator``),
    its gradients and one update of ``params`` in place, and returns the loss
    as a 0-d tensor on the device (not read back). ``state`` holds what a
    checkpoint saves beside the params: ``opt_state`` (optax.adam's tree; with
    ``sparse_embedding`` optax.masked's, over all but the id table and the
    biases) and, with ``sparse_embedding``, ``sparse_state`` (the two lazy
    Adam states); the step updates it in place. The sparse step's valid rows
    come from the host masks, so finding them reads nothing back from the
    card."""
    tx = Adam(cfg.lr)
    tree = M.jax_tree(params)
    if not cfg.sparse_embedding:
        state = {"opt_state": tx.init(tree)}
    else:
        dense = {"proj": {k: v for k, v in tree["proj"].items() if k != "id_table"},
                 "convs": tree["convs"]}
        state = {"opt_state": MaskedState(tx.init(dense)),
                 "sparse_state": {"id": init_sparse_adam_state(params.proj.id_table.detach()),
                                  "bias": init_sparse_adam_state(params.bias.detach())}}

    def step(batch, src_mask, dst_mask):
        for p in params.parameters():
            p.grad = None
        if not cfg.sparse_embedding:
            loss = M.margin_loss(params, batch, item_features, item_features_float,
                                 train=True, generator=generator)
            loss.backward()
            state["opt_state"] = tx.update_(M.grad_tree(params), state["opt_state"],
                                            M.jax_tree(params))
            return loss.detach()
        src = batch.blocks[0].src_ids
        dst = batch.blocks[-1].dst_ids
        id_rows = params.proj.id_table.detach().index_select(0, src).requires_grad_()
        bias_rows = params.bias.detach().index_select(0, dst).requires_grad_()
        loss = M.margin_loss(params, batch, item_features, item_features_float, train=True,
                             generator=generator, id_rows=id_rows, bias_rows=bias_rows)
        loss.backward()
        state["opt_state"] = MaskedState(
            tx.update_(tree_grads(dense), state["opt_state"].inner_state, dense))
        sparse = state["sparse_state"]
        _, sparse["id"] = sparse_rows_adam_update(
            params.proj.id_table, sparse["id"], src, src_mask, id_rows.grad, cfg.lr)
        _, sparse["bias"] = sparse_rows_adam_update(
            params.bias, sparse["bias"], dst, dst_mask, bias_rows.grad, cfg.lr)
        return loss.detach()

    return step, state


def _check_config(checkpoint_dir: str, cfg: PinSAGEConfig) -> None:
    """Refuse to resume a run of another configuration: the first leg writes
    ``pinsage_config.json`` (every field but ``num_epochs``, which a later leg
    may extend), and each later leg must match it."""
    path = os.path.join(checkpoint_dir, "pinsage_config.json")
    want = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "num_epochs"}
    if os.path.exists(path):
        with open(path) as f:
            have = json.load(f)
        if have != want:
            diff = {k: (have.get(k), v) for k, v in want.items() if have.get(k) != v}
            raise ValueError(f"{checkpoint_dir} holds a run of another configuration: {diff}")
        return
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(want, f)


def train(
    cfg: PinSAGEConfig,
    data: PinSAGEData,
    log_fn=print,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    max_epochs_this_run: Optional[int] = None,
    device="cuda",
) -> dict:
    """Training loop (reference ``pinsage/model.py:105-134``). Returns a dict
    with the final params (a :class:`~..models.pinsage.PinSAGEModel`), item
    embeddings and HITS@k per split.

    ``checkpoint_dir`` saves ``pinsage_<epoch>.npz`` after every epoch
    (params, Adam state, the sparse states; the JAX package's keys) and
    resumes from the newest one, with the dropout stream reseeded from the
    start epoch (no replay of epoch 0's draws). With ``max_epochs_this_run``
    a call trains that many epochs and stops: it returns ``completed=False``
    and no ``test_hits`` unless it reached ``cfg.num_epochs``. A call that
    resumes at ``cfg.num_epochs`` trains nothing: its ``loss`` and
    ``val_hits`` are None, and ``test_hits`` is measured on the restored
    params."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    sampler = PinSAGESampler(
        data,
        random_walk_length=cfg.random_walk_length,
        random_walk_restart_prob=cfg.random_walk_restart_prob,
        num_random_walks=cfg.num_random_walks,
        num_neighbors=cfg.num_neighbors,
        num_layers=cfg.num_layers,
        batch_size=cfg.batch_size,
        seed=cfg.seed,
    )
    item_features = torch.from_numpy(data.item_features.astype(np.int64)).to(dev)
    item_features_float = (
        None if data.item_features_float is None
        else torch.from_numpy(data.item_features_float.astype(np.float32)).to(dev)
    )
    cards = data.item_features.max(axis=0).tolist() if data.item_features.size else []
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = M.init_pinsage_params(
        data.num_items, [int(c) for c in cards], cfg.hidden_dims, cfg.num_layers,
        float_feature_dim=(0 if data.item_features_float is None
                           else data.item_features_float.shape[1]),
        generator=gen, device=dev,
    )
    step, state = make_train_step(cfg, params, item_features, item_features_float, gen)

    def ckpt_state():
        return {"params": M.jax_tree(params), **state}

    start_epoch = 0
    if checkpoint_dir:
        _check_config(checkpoint_dir, cfg)
        restored, ver = load_latest(checkpoint_dir, ckpt_state(), prefix="pinsage_")
        if ver is not None:
            M.load_jax_tree_(params, restored["params"])
            state.update({k: restored[k] for k in state})
            start_epoch = int(ver)
            gen.manual_seed(_resume_seed(cfg.seed, start_epoch))
            log_fn(f"[resume] from epoch {start_epoch}")

    def to_device(b):
        return b.to(dev), b.blocks[0].src_mask, b.blocks[-1].dst_mask

    loss = None
    val_hits = None
    epochs_this_run = 0
    for epoch in range(start_epoch, cfg.num_epochs):
        def epoch_batches():
            for _ in range(cfg.batches_per_epoch):
                b = sampler.sample_train_batch()
                if b is not None:
                    yield b

        for batch, src_mask, dst_mask in prefetch(epoch_batches(), buffer_size=2,
                                                  transform=to_device):
            loss = step(batch, src_mask, dst_mask)
        h_item = embed_all_items(cfg, params, data, sampler, item_features, item_features_float)
        val_hits = hits_at_k(data, h_item, cfg.k, "val", device=dev)
        loss_value = float(loss) if loss is not None else float("nan")
        log_fn(f"[epoch {epoch}] loss: {loss_value:.5f} HITS@{cfg.k} (val): {val_hits:.5f}")
        if checkpoint_dir:
            save_state(os.path.join(checkpoint_dir, f"pinsage_{epoch + 1}"), ckpt_state())
        epochs_this_run += 1
        if (max_epochs_this_run is not None and epochs_this_run >= max_epochs_this_run
                and epoch + 1 < cfg.num_epochs):
            return {"params": params, "val_hits": val_hits, "loss": loss_value,
                    "completed": False, "epochs_done": epoch + 1}

    h_item = embed_all_items(cfg, params, data, sampler, item_features, item_features_float)
    test_hits = hits_at_k(data, h_item, cfg.k, "test", device=dev)
    log_fn(f"HITS@{cfg.k} (test): {test_hits:.5f}")
    return {
        "params": params,
        "item_embeddings": h_item,
        "val_hits": val_hits,
        "test_hits": test_hits,
        "loss": float(loss) if loss is not None else None,
        "completed": True,
        "epochs_done": cfg.num_epochs,
    }


def run_pinsage_cli(artifact_dir: str, checkpoint_dir: Optional[str] = None,
                    device="cuda") -> dict:
    """CLI entry: artifacts → PinSAGE training (reference ``run_pinsage.py``);
    returns :func:`train`'s result."""
    from ..data.etl import load_artifacts

    data = build_pinsage_data(load_artifacts(artifact_dir))
    cfg = PinSAGEConfig(num_epochs=2, batches_per_epoch=200)
    return train(cfg, data, checkpoint_dir=checkpoint_dir, device=device)
