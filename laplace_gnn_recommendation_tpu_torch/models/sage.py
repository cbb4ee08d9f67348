"""Heterogeneous SAGE encoder-decoder for link-prediction ranking — the port
of the JAX package's ``models/sage.py`` (reference
``model/encoder_decoder.py:17-164`` + ``model/layers.py:6-56``).

The parameters live in :class:`SageModel`, an ``nn.Module`` of ``nn.Linear``
layers and embedding tables laid out like the JAX params tree; the model is
run by the JAX package's functions under the same names (``encode``,
``decode``, ``forward``, ``infer``, ``bce_loss``), which take the module as
their ``params`` and the BatchNorm running statistics as a separate
``bn_state`` dict, as in JAX.

Structure per forward:
1. categorical feature embeddings per node type with the max_norm=1 renorm
   applied at lookup, functionally (the tables are never rewritten),
2. L layers of bipartite SAGE message passing over the padded subgraph edges
   (aggr = ``conv_agg_type``: add/mean/max; out = lin_l(agg) + lin_r(x_dst)),
   feature dropout + ReLU on non-last layers; items combine their incoming
   edge types with ``heterogeneous_prop_agg_type``,
3. masked BatchNorm on the final user/item embeddings, with running stats,
4. an MLP edge decoder over concat(z_user ‖ z_item) at the [B, L] label grid.

Aggregation runs on the subgraph's dense [NU, NI] adjacency (duplicate
edges count; two f32 products a layer) when ``add``/``mean`` and the f32
pair fits ``cfg.dense_bytes_budget``; otherwise per edge: gathers and a
sorted segment sum (add/mean) or ``scatter_reduce("amax")`` (max). In the
JAX package both are plain XLA ops outside any Pallas kernel, and here they
are library calls. Every sum of floats runs in a fixed order (no float
atomics), so a step on the same inputs gives the same bits on either path.

Weights: JAX stores a linear layer as ``w`` [fan_in, fan_out] applied as
``x @ w``; ``nn.Linear`` stores [out, in]. :func:`jax_tree` gives the
module's tensors in the JAX layout (transposed views of the weights), which
is the layout of checkpoints and Adam moments, and
:func:`sage_params_from_jax` carries a JAX params tree over.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..configs import Config, embedding_size_for_cardinality
from ..constants import NODE_EXTRA, NODE_ITEM, NODE_USER
from ..data.graph import HeteroGraph
from ..data.sampler import SubgraphBatch
from ..ops.sorted_sum import SegmentSum as _SegmentSum
from ..ops.sorted_sum import SumPlan as _SumPlan
from ..ops.sorted_sum import gather_rows as _rows
from ..types import FeatureInfo

INFER_PAD = -float(1 << 50)  # reference model/encoder_decoder.py:164


@contextlib.contextmanager
def exact_f32_matmul():
    """f32 products in full f32 (TF32 off) for the enclosed calls, whatever
    the process-wide setting; the setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def get_feature_info(g: HeteroGraph) -> Dict[str, FeatureInfo]:
    """Per-node-type categorical metadata (reference ``utils/get_info.py:17-36``)."""
    out = {}
    for node_type, x in g.node_features.items():
        num_cat = np.max(x, axis=0).tolist() if len(x) else []
        out[node_type] = FeatureInfo(
            num_feat=x.shape[1],
            num_cat=[int(c) for c in num_cat],
            embedding_size=[embedding_size_for_cardinality(int(c)) for c in num_cat],
        )
    return out


class SageConv(nn.Module):
    """One SAGE conv along a typed edge direction: lin_l(agg) + lin_r(x_dst)."""

    def __init__(self, src_dim: int, dst_dim: int, out_dim: int):
        super().__init__()
        self.lin_l = nn.Linear(src_dim, out_dim, bias=True)
        self.lin_r = nn.Linear(dst_dim, out_dim, bias=False)


class BatchNormAffine(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class SageModel(nn.Module):
    """The encoder-decoder's parameters (JAX params tree: ``embeddings``,
    ``convs``, ``decoder``, ``bn``). ``conv_dims[l][name]`` is the
    (src_dim, dst_dim, out_dim) of layer ``l``'s conv ``name``."""

    def __init__(
        self,
        emb_shapes: Dict[str, List[Tuple[int, int]]],
        conv_dims: List[Dict[str, Tuple[int, int, int]]],
        dec_dims: List[Tuple[int, int]],
        bn_dims: Dict[str, int],
    ):
        super().__init__()
        self.embeddings = nn.ModuleDict({
            t: nn.ParameterList([nn.Parameter(torch.empty(r, d)) for r, d in shapes])
            for t, shapes in emb_shapes.items()
        })
        self.convs = nn.ModuleList([
            nn.ModuleDict({name: SageConv(*dims) for name, dims in layer.items()})
            for layer in conv_dims
        ])
        self.decoder = nn.ModuleList([nn.Linear(i, o) for i, o in dec_dims])
        self.bn = nn.ModuleDict({t: BatchNormAffine(d) for t, d in bn_dims.items()})

    def forward(self, bn_state, batch, user_features, item_features, cfg, **kw):
        """:func:`forward` with this module as its params."""
        return forward(self, bn_state, batch, user_features, item_features, cfg, **kw)


def _linear_tree(lin: nn.Linear) -> dict:
    out = {"w": lin.weight.t()}
    if lin.bias is not None:
        out["b"] = lin.bias
    return out


def jax_tree(params: SageModel) -> dict:
    """The module's parameters as the JAX params tree: nested dicts and
    lists whose leaves share the module's storage (``w`` is the transposed
    view of ``nn.Linear.weight``), so writing into a leaf writes the model."""
    return {
        "embeddings": {t: list(tables) for t, tables in params.embeddings.items()},
        "convs": [
            {name: {"lin_l": _linear_tree(c.lin_l), "lin_r": _linear_tree(c.lin_r)}
             for name, c in layer.items()}
            for layer in params.convs
        ],
        "decoder": [_linear_tree(lin) for lin in params.decoder],
        "bn": {t: {"scale": m.scale, "bias": m.bias} for t, m in params.bn.items()},
    }


def grad_tree(params: SageModel) -> dict:
    """The ``.grad`` of every parameter, in the JAX tree layout."""
    from ..train.checkpoint import tree_grads

    return tree_grads(jax_tree(params))


def load_jax_tree_(params: SageModel, tree) -> SageModel:
    """Copy a JAX-layout tree (numpy arrays or tensors) into the module."""
    from ..train.checkpoint import copy_tree_

    copy_tree_(jax_tree(params), tree)
    return params


def _model_for(cfg: Config, feature_info: Dict[str, FeatureInfo],
               float_dims: Optional[Dict[str, int]], num_extra: int) -> SageModel:
    emb_shapes: Dict[str, List[Tuple[int, int]]] = {}
    in_dim: Dict[str, int] = {}
    for node_type, info in feature_info.items():
        emb_shapes[node_type] = [(c + 1, d) for c, d in zip(info.num_cat, info.embedding_size)]
        in_dim[node_type] = int(sum(info.embedding_size))
        if float_dims:
            in_dim[node_type] += int(float_dims.get(node_type, 0))
    if num_extra > 0 and NODE_EXTRA not in feature_info:
        # identity embedding: each colour-group node embeds its own id
        d_e = embedding_size_for_cardinality(num_extra)
        emb_shapes[NODE_EXTRA] = [(num_extra, d_e)]
        in_dim[NODE_EXTRA] = d_e

    dims = [cfg.hidden_layer_size] * (cfg.num_gnn_layers - 1) + [cfg.encoder_layer_output_size]
    conv_dirs = {"item_to_user": (NODE_ITEM, NODE_USER), "user_to_item": (NODE_USER, NODE_ITEM)}
    if num_extra > 0:
        conv_dirs["extra_to_item"] = (NODE_EXTRA, NODE_ITEM)
        conv_dirs["item_to_extra"] = (NODE_ITEM, NODE_EXTRA)
    conv_dims = []
    src_dims = dict(in_dim)
    for out_dim in dims:
        conv_dims.append({name: (src_dims[s], src_dims[d], out_dim)
                          for name, (s, d) in conv_dirs.items()})
        src_dims = {t: out_dim for t in src_dims}

    d_out = cfg.encoder_layer_output_size
    dec = [2 * d_out] + [cfg.hidden_layer_size] * (cfg.num_linear_layers - 1) + [1]
    if cfg.num_linear_layers == 1:
        dec = [2 * d_out, 1]
    bn_dims = {t: d_out for t in (NODE_USER, NODE_ITEM)} if cfg.batch_norm else {}
    return SageModel(emb_shapes, conv_dims, list(zip(dec[:-1], dec[1:])), bn_dims)


def _init_bn_state(d_out: int, dev) -> dict:
    return {t: {"mean": torch.zeros(d_out, device=dev), "var": torch.ones(d_out, device=dev)}
            for t in (NODE_USER, NODE_ITEM)}


def init_sage_params(
    cfg: Config,
    feature_info: Dict[str, FeatureInfo],
    float_dims: Optional[Dict[str, int]] = None,
    num_extra: int = 0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Tuple[SageModel, dict]:
    """(params, bn_state) on ``device`` (JAX ``init_sage_params``): embedding
    tables normal(0, 1), linear layers uniform(±1/sqrt(fan_in)) as
    ``torch.nn.Linear``'s default, BatchNorm scale 1 / bias 0, running mean
    0 / var 1. ``generator`` (default: one on ``device`` seeded with 0)
    draws every value; the draws are not the JAX package's
    (:func:`sage_params_from_jax` carries JAX weights over).

    ``float_dims[node_type]`` declares non-categorical feature widths, which
    join the encoder input after the embeddings. ``num_extra > 0`` adds the
    colour-group node type (an identity embedding plus ``item↔extra`` convs
    in every layer)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = _model_for(cfg, feature_info, float_dims, num_extra).to(dev)
    with torch.no_grad():
        for tables in model.embeddings.values():
            for t in tables:
                t.copy_(torch.randn(t.shape, generator=generator, device=dev))
        lins = [lin for layer in model.convs for c in layer.values()
                for lin in (c.lin_l, c.lin_r)] + list(model.decoder)
        for lin in lins:
            bound = 1.0 / np.sqrt(max(lin.in_features, 1))
            for p in (lin.weight, lin.bias):
                if p is not None:
                    p.copy_((torch.rand(p.shape, generator=generator, device=dev) * 2 - 1) * bound)
    return model, _init_bn_state(cfg.encoder_layer_output_size, dev)


def sage_params_from_jax(params, bn_state, device="cuda") -> Tuple[SageModel, dict]:
    """Carry a JAX ``(params, bn_state)`` pair (numpy pytrees, e.g.
    ``jax.tree.map(np.asarray, params)``) over onto ``device``: the module
    is shaped from the tree and every ``w`` is transposed into
    ``nn.Linear.weight``."""
    dev = resolve_device(device)

    def lin_dims(p):
        w = np.asarray(p["w"])
        return int(w.shape[0]), int(w.shape[1])

    conv_dims = []
    for layer in params["convs"]:
        dims = {}
        for name, c in layer.items():
            src, out = lin_dims(c["lin_l"])
            dst, _ = lin_dims(c["lin_r"])
            dims[name] = (src, dst, out)
        conv_dims.append(dims)
    model = SageModel(
        {t: [tuple(np.asarray(x).shape) for x in tables]
         for t, tables in params["embeddings"].items()},
        conv_dims,
        [lin_dims(p) for p in params["decoder"]],
        {t: int(np.asarray(p["scale"]).shape[0]) for t, p in params.get("bn", {}).items()},
    ).to(dev)
    load_jax_tree_(model, params)
    bn = {t: {k: torch.tensor(np.asarray(v, np.float32), device=dev) for k, v in s.items()}
          for t, s in bn_state.items()}
    return model, bn



def _embed_features(tables, x: torch.Tensor) -> torch.Tensor:
    """Concat per-column embedding lookups with the max_norm=1 renorm of
    ``nn.Embedding(max_norm=1)`` applied to the looked-up rows only."""
    cols = []
    for i, table in enumerate(tables):
        rows = _rows(table, torch.clamp(x[:, i], 0, table.shape[0] - 1))
        norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
        cols.append(rows / torch.clamp_min(norm, 1.0))
    return torch.cat(cols, dim=-1)


def _aggregate(
    messages: torch.Tensor,  # [E, D], 0 for invalid
    dst: torch.Tensor,       # int64 [E]
    valid: torch.Tensor,     # bool [E]
    num_dst: int,
    agg: str,
    plan: Optional[_SumPlan] = None,   # of dst over num_dst
) -> torch.Tensor:
    d = messages.shape[1]
    if agg in ("add", "mean"):
        s = _SegmentSum.apply(messages, plan if plan is not None else _SumPlan(dst, num_dst))
        if agg == "add":
            return s
        # sums of ones are exact in any order
        cnt = messages.new_zeros((num_dst, 1)).index_add(0, dst, valid.to(messages.dtype)[:, None])
        return s / torch.clamp_min(cnt, 1.0)
    if agg == "max":
        neg = torch.where(valid[:, None], messages, torch.full_like(messages, -torch.inf))
        m = messages.new_full((num_dst, d), -torch.inf).scatter_reduce(
            0, dst[:, None].expand(-1, d), neg, "amax", include_self=False)
        # empty segments (and segments of invalid edges only) keep -inf → 0
        return torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    raise ValueError(f"unknown conv_agg_type {agg}")


def _combine_hetero(stacks: List[torch.Tensor], agg: str) -> torch.Tensor:
    """Per-destination aggregation over incoming edge types (to_hetero's
    ``aggr``)."""
    if len(stacks) == 1:
        return stacks[0]
    s = torch.stack(stacks)
    if agg == "sum":
        return s.sum(0)
    if agg == "mean":
        return s.mean(0)
    if agg == "min":
        return s.min(0).values
    if agg == "max":
        return s.max(0).values
    if agg == "mul":
        return s.prod(0)
    raise ValueError(f"unknown heterogeneous_prop_agg_type {agg}")


def _batch_norm(x, mask, p, state, train: bool, momentum: float = 0.1, eps: float = 1e-5):
    """Masked BatchNorm1d with running stats; the running variance takes
    the unbiased n/(n−1) correction (JAX ``:259-279``)."""
    if train:
        m = mask.to(x.dtype)[:, None]
        n = torch.clamp_min(m.sum(), 1.0)
        mean = (x * m).sum(0) / n
        var = (((x - mean) ** 2) * m).sum(0) / n
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * state["var"]
            + momentum * var.detach() * n / torch.clamp_min(n - 1.0, 1.0),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p.scale + p.bias, new_state


def _dropout(generator, x, p, train: bool):
    if not train or p is None or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _on_device(batch: SubgraphBatch, dev: torch.device) -> SubgraphBatch:
    if isinstance(batch.user_ids, torch.Tensor) and batch.user_ids.device == dev:
        return batch
    return batch.to(dev)


def encode(
    params: SageModel,
    bn_state: dict,
    batch: SubgraphBatch,
    user_features: torch.Tensor,   # int [num_users, F_u] full table on device
    item_features: torch.Tensor,   # int [num_items, F_i]
    cfg: Config,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    user_features_float: Optional[torch.Tensor] = None,  # f32 [num_users, Dfu]
    item_features_float: Optional[torch.Tensor] = None,  # f32 [num_items, Dfi]
    item_extra_ids: Optional[torch.Tensor] = None,       # int [num_items], -1 none
    extra_features: Optional[torch.Tensor] = None,       # int [num_extra, F_e]
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Embeddings + hetero SAGE stack → (z_user, z_item, bn_state) (JAX
    ``encode``). ``batch`` moves to the features' device if it is not there.
    ``generator`` draws the dropout masks in train mode. With
    ``item_extra_ids`` (and params built with ``num_extra > 0``) every
    colour-group node joins the batch and items aggregate over both incoming
    edge types."""
    dev = user_features.device
    batch = _on_device(batch, dev)
    extra_active = item_extra_ids is not None and NODE_EXTRA in params.embeddings
    x_user = _embed_features(params.embeddings[NODE_USER], user_features[batch.user_ids])
    x_item = _embed_features(params.embeddings[NODE_ITEM], item_features[batch.item_ids])
    if user_features_float is not None:
        x_user = torch.cat([x_user, user_features_float[batch.user_ids]], dim=-1)
    if item_features_float is not None:
        x_item = torch.cat([x_item, item_features_float[batch.item_ids]], dim=-1)
    x_user = x_user * batch.user_mask[:, None]
    x_item = x_item * batch.item_mask[:, None]

    x_extra = e_of_item = has_extra_edge = None
    if extra_active:
        if extra_features is None:
            ne = params.embeddings[NODE_EXTRA][0].shape[0]
            extra_features = torch.arange(ne, device=dev)[:, None]
        ne = extra_features.shape[0]
        x_extra = _embed_features(params.embeddings[NODE_EXTRA], extra_features)
        raw_extra = item_extra_ids[batch.item_ids]
        has_extra_edge = batch.item_mask & (raw_extra >= 0)
        e_of_item = torch.clamp(raw_extra, 0, ne - 1)

    nu, ni = x_user.shape[0], x_item.shape[0]
    emask = batch.edge_mask
    src, dst = batch.edge_src, batch.edge_dst
    agg_type = cfg.conv_agg_type
    dense_budget = getattr(cfg, "dense_bytes_budget", 0) or 0
    use_dense = agg_type in ("add", "mean") and 0 < 2 * nu * ni * 4 <= dense_budget
    if use_dense:
        # entries count duplicate (u, i) edges, so add/mean equal the segment
        # path; sums of ones are exact in any order of the atomics
        adj = x_user.new_zeros(nu * ni).index_add_(0, src * ni + dst, emask.to(x_user.dtype))
        adj = adj.view(nu, ni)
        if agg_type == "mean":
            inv_deg_u = 1.0 / torch.clamp_min(adj.sum(1, keepdim=True), 1.0)
            inv_deg_i = 1.0 / torch.clamp_min(adj.sum(0)[:, None], 1.0)
    else:
        # the edges by user slot and by item slot, for every layer's sums
        by_user, by_item = _SumPlan(src, nu), _SumPlan(dst, ni)

    def agg_user(x_item_cur):
        """Item messages into user slots (dst = edge_src)."""
        if use_dense:
            with exact_f32_matmul():
                a = adj @ x_item_cur
            return a * inv_deg_u if agg_type == "mean" else a
        msgs = torch.where(emask[:, None], _rows(x_item_cur, dst, by_item),
                           torch.zeros((), device=dev))
        return _aggregate(msgs, src, emask, nu, agg_type, by_user)

    def agg_item(x_user_cur):
        """User messages into item slots (dst = edge_dst)."""
        if use_dense:
            with exact_f32_matmul():
                a = adj.t() @ x_user_cur
            return a * inv_deg_i if agg_type == "mean" else a
        msgs = torch.where(emask[:, None], _rows(x_user_cur, src, by_user),
                           torch.zeros((), device=dev))
        return _aggregate(msgs, dst, emask, ni, agg_type, by_item)

    num_layers = len(params.convs)
    p_drop = cfg.p_dropout_features
    for li, layer in enumerate(params.convs):
        last = li == num_layers - 1
        if not last:
            x_user = _dropout(generator, x_user, p_drop, train)
            x_item = _dropout(generator, x_item, p_drop, train)
            if extra_active:
                x_extra = _dropout(generator, x_extra, p_drop, train)

        with exact_f32_matmul():
            c = layer["item_to_user"]
            out_u = c.lin_l(agg_user(x_item)) + c.lin_r(x_user)
            out_u = _combine_hetero([out_u], cfg.heterogeneous_prop_agg_type)

            c = layer["user_to_item"]
            item_stacks = [c.lin_l(agg_item(x_user)) + c.lin_r(x_item)]
            out_e = None
            if extra_active:
                # an item has at most one has_color edge: its aggregation is
                # that one message under add/mean/max; edge-less items get none
                c = layer["extra_to_item"]
                agg_ie = _rows(x_extra, e_of_item) * has_extra_edge[:, None]
                item_stacks.append(c.lin_l(agg_ie) + c.lin_r(x_item))
                c = layer["item_to_extra"]
                agg_e = _aggregate(x_item * has_extra_edge[:, None], e_of_item,
                                   has_extra_edge, x_extra.shape[0], agg_type)
                out_e = c.lin_l(agg_e) + c.lin_r(x_extra)
        out_i = _combine_hetero(item_stacks, cfg.heterogeneous_prop_agg_type)

        if not last:
            out_u, out_i = F.relu(out_u), F.relu(out_i)
            if out_e is not None:
                out_e = F.relu(out_e)
        x_user, x_item = out_u, out_i
        if extra_active:
            x_extra = out_e

    new_bn_state = bn_state
    if cfg.batch_norm:
        x_user, s_u = _batch_norm(x_user, batch.user_mask, params.bn[NODE_USER],
                                  bn_state[NODE_USER], train)
        x_item, s_i = _batch_norm(x_item, batch.item_mask, params.bn[NODE_ITEM],
                                  bn_state[NODE_ITEM], train)
        new_bn_state = {NODE_USER: s_u, NODE_ITEM: s_i}
    return x_user, x_item, new_bn_state


def decode(
    params: SageModel,
    z_user: torch.Tensor,
    z_item: torch.Tensor,
    batch: SubgraphBatch,
    cfg: Config,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """MLP edge decoder over the [B, L] label grid → logits [B, L]."""
    batch = _on_device(batch, z_user.device)
    z = torch.cat([_rows(z_user, batch.label_src), _rows(z_item, batch.label_dst)], dim=-1)
    n = len(params.decoder)
    with exact_f32_matmul():
        for i, lin in enumerate(params.decoder):
            last = i == n - 1
            if not last:
                z = _dropout(generator, z, cfg.p_dropout_features, train)
            z = lin(z)
            if not last:
                z = F.relu(z)
    return z[..., 0]


def forward(
    params: SageModel, bn_state: dict, batch: SubgraphBatch,
    user_features, item_features, cfg: Config,
    train: bool = False, generator: Optional[torch.Generator] = None,
    user_features_float=None, item_features_float=None,
    item_extra_ids=None, extra_features=None,
) -> Tuple[torch.Tensor, dict]:
    """Full model: logits [B, L] + the new bn state."""
    batch = _on_device(batch, user_features.device)
    z_u, z_i, bn_state = encode(
        params, bn_state, batch, user_features, item_features, cfg, train, generator,
        user_features_float, item_features_float, item_extra_ids, extra_features,
    )
    return decode(params, z_u, z_i, batch, cfg, train, generator), bn_state


def infer(
    params: SageModel, bn_state: dict, batch: SubgraphBatch,
    user_features, item_features, cfg: Config,
    user_features_float=None, item_features_float=None,
    item_extra_ids=None, extra_features=None,
) -> torch.Tensor:
    """Eval-mode per-user padded score matrix [B, L]; invalid slots hold
    ``INFER_PAD`` (-2⁵⁰)."""
    batch = _on_device(batch, user_features.device)
    logits, _ = forward(
        params, bn_state, batch, user_features, item_features, cfg, train=False,
        user_features_float=user_features_float, item_features_float=item_features_float,
        item_extra_ids=item_extra_ids, extra_features=extra_features,
    )
    return torch.where(batch.label_mask, logits, torch.full_like(logits, INFER_PAD))


def bce_loss(logits: torch.Tensor, batch: SubgraphBatch) -> torch.Tensor:
    """Masked BCE-with-logits over the label grid (reference
    ``training.py:26-31``): max(x,0) − x·y + log1p(exp(−|x|))."""
    batch = _on_device(batch, logits.device)
    per_edge = (torch.clamp_min(logits, 0.0) - logits * batch.label
                + torch.log1p(torch.exp(-logits.abs())))
    m = batch.label_mask.to(logits.dtype)
    return (per_edge * m).sum() / torch.clamp_min(m.sum(), 1.0)
