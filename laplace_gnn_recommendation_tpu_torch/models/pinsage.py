"""PinSAGE model — the port of the JAX package's ``models/pinsage.py``
(reference ``pinsage/layers.py:90-203`` + ``pinsage/model.py:16-33``), over
the padded :class:`~..data.pinsage_data.PinSAGEBlock`\\ s:

* :func:`project` — per-feature embedding projections summed, plus the
  learnable per-item id embedding (``LinearProjector``, ``layers.py:90-118``;
  ``model.py:50-51``),
* :func:`weighted_sage_conv` — n = act(Q(dropout(h_src))); visit-count
  weighted neighbour sum ÷ clamped weight sum; z = act(W(dropout([n/ws ‖
  h_dst]))); L2-normalized with a 0→1 guard (``layers.py:121-156``),
* :func:`get_repr` — projected dst + SAGE stack output (``model.py:30-33``),
* :func:`score_pairs` — u·v + per-item biases (``layers.py:181-203``),
* :func:`margin_loss` — masked mean of (neg − pos + 1)₊ (``model.py:24-28``).

The parameters live in :class:`PinSAGEModel`; the functions take it as their
``params``, as the JAX functions take the params tree. :func:`jax_tree`
shows the module as that tree (``w`` is the transposed view of
``nn.Linear.weight``), the layout of checkpoints and Adam moments, and
:func:`pinsage_params_from_jax` carries a JAX tree over. Every gather that
takes a gradient and every segment sum runs through ``ops/sorted_sum`` (no
float atomics: the small feature tables, the pad slots' item 0 and the pair
slots repeat rows thousands of times a batch), so one batch's gradients
repeat bit for bit. Dropout draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from .. import resolve_device
from ..data.pinsage_data import PinSAGEBatch, PinSAGEBlock
from ..ops.sorted_sum import SegmentSum, SumPlan, gather_rows


class Projector(nn.Module):
    """``proj``: categorical tables, the id table, an optional linear map of
    float features."""

    def __init__(self, num_items: int, table_rows: List[int], hidden: int,
                 float_feature_dim: int = 0):
        super().__init__()
        self.tables = nn.ParameterList([nn.Parameter(torch.empty(r, hidden)) for r in table_rows])
        self.id_table = nn.Parameter(torch.empty(num_items, hidden))
        self.float_lin = nn.Linear(float_feature_dim, hidden) if float_feature_dim else None


class WeightedSAGEConv(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.Q = nn.Linear(hidden, hidden)
        self.W = nn.Linear(2 * hidden, hidden)


class PinSAGEModel(nn.Module):
    """The JAX params tree ``{"proj", "convs", "bias"}`` as a module."""

    def __init__(self, num_items: int, table_rows: List[int], hidden: int, n_layers: int,
                 float_feature_dim: int = 0):
        super().__init__()
        self.proj = Projector(num_items, table_rows, hidden, float_feature_dim)
        self.convs = nn.ModuleList([WeightedSAGEConv(hidden) for _ in range(n_layers)])
        self.bias = nn.Parameter(torch.zeros(num_items))


def _linear_tree(lin: nn.Linear) -> dict:
    return {"w": lin.weight.t(), "b": lin.bias}


def jax_tree(params: PinSAGEModel) -> dict:
    """The module's parameters as the JAX params tree; the leaves share the
    module's storage."""
    proj = {"tables": list(params.proj.tables), "id_table": params.proj.id_table}
    if params.proj.float_lin is not None:
        proj["float_lin"] = _linear_tree(params.proj.float_lin)
    return {
        "proj": proj,
        "convs": [{"Q": _linear_tree(c.Q), "W": _linear_tree(c.W)} for c in params.convs],
        "bias": params.bias,
    }


def grad_tree(params: PinSAGEModel) -> dict:
    """The ``.grad`` of every parameter, in the JAX tree layout."""
    from ..train.checkpoint import tree_grads

    return tree_grads(jax_tree(params))


def load_jax_tree_(params: PinSAGEModel, tree) -> PinSAGEModel:
    """Copy a JAX-layout tree (numpy arrays or tensors) into the module."""
    from ..train.checkpoint import copy_tree_

    copy_tree_(jax_tree(params), tree)
    return params


def init_pinsage_params(
    num_items: int,
    feature_cardinalities: List[int],
    hidden_dims: int,
    n_layers: int,
    float_feature_dim: int = 0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> PinSAGEModel:
    """The model on ``device`` (JAX ``init_pinsage_params``):
    ``feature_cardinalities[i]`` is the largest category id of item-feature
    column i (its table has that + 2 rows, ``layers.py:35``). Tables and
    weights are Xavier-uniform (gain √2 on the conv weights, the ReLU gain of
    ``layers.py:132``), biases 0. ``generator`` (default: one on ``device``
    seeded with 0) draws every value; the draws are not the JAX package's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = PinSAGEModel(num_items, [c + 2 for c in feature_cardinalities], hidden_dims,
                         n_layers, float_feature_dim).to(dev)
    gain = float(np.sqrt(2.0))
    with torch.no_grad():
        tree = jax_tree(model)
        fills = [(t, 1.0) for t in tree["proj"]["tables"]] + [(tree["proj"]["id_table"], 1.0)]
        if "float_lin" in tree["proj"]:
            fills.append((tree["proj"]["float_lin"]["w"], 1.0))
        fills += [(c[name]["w"], gain) for c in tree["convs"] for name in ("Q", "W")]
        for w, g in fills:
            # w is [fan_in, fan_out], as the JAX tree stores it
            bound = g * float(np.sqrt(6.0 / (w.shape[0] + w.shape[1])))
            w.copy_((torch.rand(w.shape, generator=generator, device=dev) * 2 - 1) * bound)
        for lin in [c.Q for c in model.convs] + [c.W for c in model.convs] + \
                [model.proj.float_lin]:
            if lin is not None:
                lin.bias.zero_()
    return model


def pinsage_params_from_jax(tree, device="cuda") -> PinSAGEModel:
    """Carry a JAX params tree (numpy leaves, e.g. ``jax.tree.map(np.asarray,
    params)``) over onto ``device``: the module is shaped from the tree."""
    dev = resolve_device(device)
    proj = tree["proj"]
    id_rows, hidden = np.asarray(proj["id_table"]).shape
    ff = proj.get("float_lin")
    model = PinSAGEModel(
        int(id_rows), [int(np.asarray(t).shape[0]) for t in proj["tables"]], int(hidden),
        len(tree["convs"]), int(np.asarray(ff["w"]).shape[0]) if ff is not None else 0,
    ).to(dev)
    return load_jax_tree_(model, tree)


def project(
    params: PinSAGEModel,
    item_ids: torch.Tensor,            # int [N] global ids
    item_features: torch.Tensor,       # int [I, F] full table
    item_features_float: Optional[torch.Tensor] = None,  # [I, D] or None
    id_rows: Optional[torch.Tensor] = None,  # [N, H] pre-gathered id rows
) -> torch.Tensor:
    """Sum of per-feature projections + id embedding (LinearProjector).
    ``id_rows`` lets the sparse-embedding path differentiate w.r.t. just the
    gathered id rows instead of the whole table."""
    item_ids = item_ids.long()
    feats = item_features.index_select(0, item_ids)
    out = id_rows if id_rows is not None else gather_rows(params.proj.id_table, item_ids)
    for i, table in enumerate(params.proj.tables):
        out = out + gather_rows(table, torch.clamp(feats[:, i], 0, table.shape[0] - 1))
    lin = params.proj.float_lin
    if item_features_float is not None and lin is not None:
        out = out + item_features_float.index_select(0, item_ids) @ lin.weight.t() + lin.bias
    return out


def _dropout(generator, x, p: float, train: bool):
    if not train or p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def weighted_sage_conv(
    p: WeightedSAGEConv,
    block: PinSAGEBlock,
    h_src: torch.Tensor,   # [S, H]
    train: bool,
    generator: Optional[torch.Generator] = None,
    dropout_p: float = 0.5,
) -> torch.Tensor:
    """One WeightedSAGEConv step → [D, H] (``layers.py:138-156``)."""
    n = torch.relu(_dropout(generator, h_src, dropout_p, train) @ p.Q.weight.t() + p.Q.bias)
    d = block.dst_ids.shape[0]
    w = block.edge_w.to(h_src.dtype)
    by_dst = SumPlan(block.edge_dst, d)
    msgs = gather_rows(n, block.edge_src) * w[:, None]
    agg = SegmentSum.apply(msgs, by_dst)
    ws = torch.clamp_min(by_dst.sum(w[:, None]), 1.0)   # sums of counts: exact
    h_dst = h_src[:d]  # dst nodes lead the src slot layout
    z = torch.cat([agg / ws, h_dst], dim=-1)
    z = torch.relu(_dropout(generator, z, dropout_p, train) @ p.W.weight.t() + p.W.bias)
    norm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return z / torch.where(norm == 0.0, torch.ones_like(norm), norm)


def get_repr(
    params: PinSAGEModel,
    blocks: List[PinSAGEBlock],
    item_features: torch.Tensor,
    item_features_float: Optional[torch.Tensor],
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    id_rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Item representations on the innermost dst slots (``model.py:30-33``).
    ``id_rows`` (aligned with ``blocks[0].src_ids``) drives the
    sparse-embedding path. Every inner layout is a prefix of the outermost
    src layout (``blocks[-1].dst_ids == blocks[0].src_ids[:D]``), so the dst
    projection is the first D rows of the src one: the JAX function projects
    them again, to the same values."""
    h0 = project(params, blocks[0].src_ids, item_features, item_features_float, id_rows)
    h = h0
    for p, block in zip(params.convs, blocks):
        h = weighted_sage_conv(p, block, h, train, generator)
    return h0[: blocks[-1].dst_ids.shape[0]] + h


def score_pairs(
    params: PinSAGEModel,
    h: torch.Tensor,          # [D, H] reprs on the innermost dst slots
    dst_ids: torch.Tensor,    # int [D] global ids of those slots
    head: torch.Tensor,
    tail: torch.Tensor,
    bias_rows: Optional[torch.Tensor] = None,  # [D] pre-gathered biases
) -> torch.Tensor:
    """u·v + bias_u + bias_v (ItemToItemScorer, ``layers.py:193-203``); one
    gather of heads and tails together."""
    n = head.shape[0]
    both = torch.cat([head, tail]).long()
    ht = gather_rows(h, both)
    s = torch.sum(ht[:n] * ht[n:], dim=-1)
    if bias_rows is not None:
        b = gather_rows(bias_rows.view(-1, 1), both).view(-1)
    else:
        b = gather_rows(params.bias.view(-1, 1), dst_ids.long().index_select(0, both)).view(-1)
    return s + b[:n] + b[n:]


def margin_loss(
    params: PinSAGEModel,
    batch: PinSAGEBatch,
    item_features: torch.Tensor,
    item_features_float: Optional[torch.Tensor],
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    id_rows: Optional[torch.Tensor] = None,
    bias_rows: Optional[torch.Tensor] = None,
    rows: Optional[slice] = None,
) -> torch.Tensor:
    """Masked mean of (neg − pos + 1)₊ (``model.py:24-28``); positive and
    negative pairs are scored in one :func:`score_pairs` call. With
    ``rows`` only that slice of the pairs is scored, and the result is its
    share of the whole batch's mean (a data-parallel step's share)."""
    h = get_repr(params, batch.blocks, item_features, item_features_float, train, generator,
                 id_rows)
    ph, pt, nh, nt = batch.pos_head, batch.pos_tail, batch.neg_head, batch.neg_tail
    mask = batch.pair_mask
    count = torch.clamp_min(torch.sum(mask.to(torch.float32)), 1.0)
    if rows is not None:
        ph, pt, nh, nt, mask = ph[rows], pt[rows], nh[rows], nt[rows], mask[rows]
    p = ph.shape[0]
    s = score_pairs(params, h, batch.blocks[-1].dst_ids,
                    torch.cat([ph, nh]), torch.cat([pt, nt]), bias_rows)
    hinge = torch.clamp_min(s[p:] - s[:p] + 1.0, 0.0)
    m = mask.to(hinge.dtype)
    return torch.sum(hinge * m) / count
