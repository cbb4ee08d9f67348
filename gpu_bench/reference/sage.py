"""Plain reference of the hetero SAGE encoder-decoder (reference
``model/encoder_decoder.py`` + ``model/layers.py``), in float32 with TF32
off: categorical embeddings renormalised to max-norm 1 at lookup, L layers
of bipartite SAGE (lin_l of the summed neighbours + lin_r of the node),
ReLU and feature dropout between layers, masked BatchNorm, an MLP decoder
over the label grid, the masked BCE, autograd gradients and Adam written
out. It imports nothing of the program under test.

Weights are a tree in the JAX layout (``w`` as [fan_in, fan_out]):
``embeddings[node][col]``, ``convs[l][name]{lin_l: {w, b}, lin_r: {w}}``,
``decoder[l]{w, b}``, ``bn[node]{scale, bias}``. A batch is a dict of the
sampler's padded arrays as tensors. Dropout draws come from a generator in
the program's order: per non-last layer the user then the item slots'
inputs, then the decoder's input before every non-last linear map.

``tf32`` computes every product in TF32 (the control: one precision below
the configuration's f32).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpu_bench.reference.lightgcn import B1, B2, EPS, matmul_precision

USER, ITEM = "customer", "article"


def _embed(tables: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    cols = []
    for i, t in enumerate(tables):
        rows = t[x[:, i].clamp(0, t.shape[0] - 1)]
        cols.append(rows / rows.norm(dim=-1, keepdim=True).clamp_min(1.0))
    return torch.cat(cols, -1)


def _lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _dropout(gen, x, p: float):
    if not p:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def forward(tree: dict, batch: Dict[str, torch.Tensor], user_feats, item_feats, cfg: dict,
            gen: torch.Generator) -> torch.Tensor:
    """Logits [B, L] on the batch's label grid, in train mode: dropout from
    ``gen``, BatchNorm with the batch's statistics over the valid slots."""
    um, im, em = batch["user_mask"], batch["item_mask"], batch["edge_mask"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    xu = _embed(tree["embeddings"][USER], user_feats[batch["user_ids"]]) * um[:, None]
    xi = _embed(tree["embeddings"][ITEM], item_feats[batch["item_ids"]]) * im[:, None]
    p = float(cfg["p_dropout_features"] or 0.0)
    ew = em.to(xu.dtype)[:, None]
    layers = tree["convs"]
    for li, layer in enumerate(layers):
        last = li == len(layers) - 1
        if not last:
            xu, xi = _dropout(gen, xu, p), _dropout(gen, xi, p)
        agg_u = xi.new_zeros(xu.shape[0], xi.shape[1]).index_add_(0, src, xi[dst] * ew)
        agg_i = xu.new_zeros(xi.shape[0], xu.shape[1]).index_add_(0, dst, xu[src] * ew)
        c_u, c_i = layer["item_to_user"], layer["user_to_item"]
        ou = _lin(c_u["lin_l"], agg_u) + _lin(c_u["lin_r"], xu)
        oi = _lin(c_i["lin_l"], agg_i) + _lin(c_i["lin_r"], xi)
        if not last:
            ou, oi = F.relu(ou), F.relu(oi)
        xu, xi = ou, oi
    if cfg["batch_norm"]:
        xu = _bn(xu, um, tree["bn"][USER])
        xi = _bn(xi, im, tree["bn"][ITEM])
    z = torch.cat([xu[batch["label_src"]], xi[batch["label_dst"]]], -1)
    dec = tree["decoder"]
    for i, lin in enumerate(dec):
        last = i == len(dec) - 1
        if not last:
            z = _dropout(gen, z, p)
        z = _lin(lin, z)
        if not last:
            z = F.relu(z)
    return z[..., 0]


def _bn(x, mask, p, eps: float = 1e-5):
    m = mask.to(x.dtype)[:, None]
    n = m.sum().clamp_min(1.0)
    mean = (x * m).sum(0) / n
    var = (((x - mean) ** 2) * m).sum(0) / n
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def bce(logits, batch, rows: Optional[int] = None) -> torch.Tensor:
    """Masked BCE mean over the label grid (over its first ``rows`` rows)."""
    y, m = batch["label"], batch["label_mask"].to(logits.dtype)
    if rows is not None:
        logits, y, m = logits[:rows], y[:rows], m[:rows]
    per = logits.clamp_min(0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    return (per * m).sum() / m.sum().clamp_min(1.0)


def leaves(tree, prefix="") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in (sorted(items, key=lambda kv: str(kv[0])) if isinstance(tree, dict) else items):
        out += leaves(v, f"{prefix}/{k}")
    return out


def map_tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return [map_tree(fn, v) for v in tree]


def train_steps(tree0: dict, batches: List[dict], user_feats, item_feats, cfg: dict,
                gen_state: torch.Tensor, tf32: bool = False, half: bool = False) -> dict:
    """Follow the program's first train steps on its batches from the same
    weights and dropout generator state: each step's loss, the first
    step's gradient per leaf and each leaf's change after the last step.
    ``half`` plants a fault: the loss is the mean over the first half of
    the label grid's rows only."""
    dev = user_feats.device
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    tree = map_tree(lambda t: t.detach().clone(), tree0)
    names = [n for n, _ in leaves(tree)]
    mu = {n: torch.zeros_like(t) for n, t in leaves(tree)}
    nv = {n: torch.zeros_like(t) for n, t in leaves(tree)}
    lr = float(cfg["learning_rate"])
    losses, first = [], None
    with matmul_precision(tf32):
        for n, batch in enumerate(batches):
            params = [t.requires_grad_() for _, t in leaves(tree)]
            logits = forward(tree, batch, user_feats, item_feats, cfg, gen)
            loss = bce(logits, batch, logits.shape[0] // 2 if half else None)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            losses.append(float(loss.detach()))
            if first is None:
                first = dict(zip(names, [g.detach().clone() for g in grads]))
            t = n + 1
            with torch.no_grad():
                for name, p, g in zip(names, params, grads):
                    m, v = mu[name], nv[name]
                    m.mul_(B1).add_(g, alpha=1 - B1)
                    v.mul_(B2).addcmul_(g, g, value=1 - B2)
                    p.sub_(lr * (m / (1 - B1 ** t)) / (torch.sqrt(v / (1 - B2 ** t)) + EPS))
            tree = map_tree(lambda x: x.detach(), tree)
    change = {n: t - t0 for (n, t), (_, t0) in zip(leaves(tree), leaves(tree0))}
    return {"loss": losses, "grad": first, "change": change}


# ---- batch validity -------------------------------------------------------------

def batch_violations(batch: Dict[str, np.ndarray], keys: np.ndarray, num_items: int,
                     seeds: np.ndarray, fanout_users: int) -> int:
    """How many ways a sampled batch breaks the sampler's contract, against
    the graph's sorted (user·I + item) keys: seeds other than the requested
    ones, valid edges or positive labels that are not edges of the graph,
    label rows whose source slot is not their seed's, repeated node ids, or
    more distinct users than B·(1 + fanout)."""
    def absent(u, i):
        q = np.asarray(u, np.int64) * num_items + np.asarray(i, np.int64)
        at = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return int((keys[at] != q).sum())

    bad = int((np.asarray(batch["seed_users"]) != np.asarray(seeds)).sum())
    uid, iid = np.asarray(batch["user_ids"]), np.asarray(batch["item_ids"])
    em = np.asarray(batch["edge_mask"], bool)
    bad += absent(uid[batch["edge_src"][em]], iid[batch["edge_dst"][em]])
    lm = np.asarray(batch["label_mask"], bool)
    pos = lm & (np.asarray(batch["label"]) > 0)
    rows = np.nonzero(pos)[0]
    bad += absent(np.asarray(batch["seed_users"])[rows], np.asarray(batch["label_item_global"])[pos])
    seed_slot = np.asarray(batch["seed_slots"])
    bad += int((np.asarray(batch["label_src"])[lm] != np.repeat(seed_slot, lm.sum(1))).sum())
    bad += int((uid[np.asarray(batch["seed_slots"])] != np.asarray(batch["seed_users"])).sum())
    bad += int((iid[np.asarray(batch["label_dst"])[lm]] != np.asarray(batch["label_item_global"])[lm]).sum())
    vu = uid[np.asarray(batch["user_mask"], bool)]
    vi = iid[np.asarray(batch["item_mask"], bool)]
    bad += (len(vu) - len(np.unique(vu))) + (len(vi) - len(np.unique(vi)))
    bad += max(0, len(vu) - len(seeds) * (1 + fanout_users))
    return bad
