"""Plain reference of LightGCN training and of masked top-k retrieval, in
float32 with TF32 off: ``index_add_`` propagation, autograd for the
gradients, Adam written out. It imports nothing of the program under test;
where the program draws at random, the same draws are made here from the
same generator state, with the calls the program's contract names
(``randint`` over the edges, then 8 candidate rounds per edge).

``lower`` switches the propagation's gathers to the control's precision:
messages bf16(bf16(w)·bf16(x)) in the program become e4m3 products with a
per-tensor scale here (the next precision below the configuration's bf16
gathers).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

NUM_TRIES = 8
B1, B2, EPS = 0.9, 0.999, 1e-8
DECAY_RATE = 0.95


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one per-tensor scale (amax → 448)."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _messages(w: torch.Tensor, x: torch.Tensor, lower: bool) -> torch.Tensor:
    if not lower:
        return w[:, None] * x
    return _fp8(_fp8(w)[:, None] * _fp8(x))


def edge_weights(eu: torch.Tensor, ei: torch.Tensor, nu: int, ni: int) -> torch.Tensor:
    """Symmetric normalisation 1/sqrt(deg(u)·deg(i)), f32."""
    du = torch.bincount(eu, minlength=nu).double()
    di = torch.bincount(ei, minlength=ni).double()
    return (1.0 / torch.sqrt(du[eu] * di[ei])).float()


def propagate(eu, ei, w, user0, item0, hops: int, lower: bool = False):
    """(users_final, items_final): E^{k+1} = Ã E^k, final = mean(E⁰..E^K)."""
    u, it = user0, item0
    su, si = user0, item0
    for _ in range(hops):
        nu_ = torch.zeros_like(u).index_add_(0, eu, _messages(w, it[ei], lower))
        ni_ = torch.zeros_like(it).index_add_(0, ei, _messages(w, u[eu], lower))
        u, it = nu_, ni_
        su, si = su + u, si + it
    return su / (hops + 1), si / (hops + 1)


def draw_bpr_batch(gen: torch.Generator, eu, ei, keys, num_items: int, batch: int):
    """(u, pos, neg) as the program's contract draws them: edges uniform
    with replacement over the (user, item)-sorted edge list, then the first
    of 8 uniform candidates that is not a positive of the user (the last
    round where all are)."""
    dev = gen.device
    idx = torch.randint(0, int(eu.numel()), (batch,), generator=gen, device=dev)
    u, pos = eu[idx], ei[idx]
    cands = torch.randint(0, num_items, (batch, NUM_TRIES), generator=gen, device=dev,
                          dtype=torch.int32).long()
    q = u[:, None] * num_items + cands
    at = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    is_pos = keys[at] == q
    rounds = torch.arange(NUM_TRIES, device=dev).expand(batch, NUM_TRIES)
    first = torch.where(is_pos, NUM_TRIES, rounds).amin(1)
    pick = torch.where(first < NUM_TRIES, first, NUM_TRIES - 1)
    return u, pos, cands.gather(1, pick[:, None])[:, 0]


def bpr_loss(uf, u0, pf, p0, nf, n0, lam: float) -> torch.Tensor:
    reg = lam * (u0.pow(2).sum() + p0.pow(2).sum() + n0.pow(2).sum())
    diff = (uf * pf).sum(-1) - (uf * nf).sum(-1)
    return -F.logsigmoid(diff).mean() + reg


def train_steps(eu, ei, nu: int, ni: int, user0, item0, cfg: Dict, gen_state: torch.Tensor,
                steps: int, lower: bool = False, half: bool = False) -> Dict[str, List]:
    """Follow ``steps`` train steps from the E⁰ tables and the generator
    state the program's first step started from. Returns each step's loss,
    the first step's gradient per table and each table's change after the
    last step. ``half`` plants a fault: each step's loss is the mean over
    the first half of its batch only."""
    dev = user0.device
    keys = eu * ni + ei                      # sorted: the edges are (user, item)-sorted
    w = edge_weights(eu, ei, nu, ni)
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    params = [user0.clone(), item0.clone()]
    mu = [torch.zeros_like(p) for p in params]
    nv = [torch.zeros_like(p) for p in params]
    losses, first_grads = [], None
    for n in range(steps):
        u, pos, neg = draw_bpr_batch(gen, eu, ei, keys, ni, int(cfg["batch_size"]))
        if half:
            u, pos, neg = (x[: x.shape[0] // 2] for x in (u, pos, neg))
        e0 = [p.detach().requires_grad_() for p in params]
        uf, itf = propagate(eu, ei, w, e0[0], e0[1], int(cfg["num_iterations"]), lower)
        loss = bpr_loss(uf[u], e0[0][u], itf[pos], e0[1][pos], itf[neg], e0[1][neg],
                        float(cfg["Lambda"]))
        grads = torch.autograd.grad(loss, e0)
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = [g.detach().clone() for g in grads]
        lr = float(cfg["learning_rate"]) * DECAY_RATE ** (n // int(cfg["lr_decay_every"]))
        t = n + 1
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nv):
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).addcmul_(g, g, value=1 - B2)
                p.sub_(lr * (m / (1 - B1 ** t)) / (torch.sqrt(v / (1 - B2 ** t)) + EPS))
        del e0, uf, itf, loss, grads
    change = [p - p0 for p, p0 in zip(params, (user0, item0))]
    return {"loss": losses, "grad": first_grads, "change": change}


# ---- retrieval ------------------------------------------------------------------

def exclusion_rows(row_ptr: torch.Tensor, items: torch.Tensor, users: torch.Tensor):
    """(row, item) pairs of every excluded item of ``users`` (CSR over the
    (user, item)-sorted train edges)."""
    lo, hi = row_ptr[users], row_ptr[users + 1]
    cnt = hi - lo
    rows = torch.repeat_interleave(torch.arange(users.numel(), device=users.device), cnt)
    offs = torch.arange(int(cnt.sum()), device=users.device) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    return rows, items[torch.repeat_interleave(lo, cnt) + offs]


def masked_scores(user_vecs, item_emb, row_ptr, ex_items, users, tf32: bool = False):
    """[b, I] scores with every excluded (user, item) at -inf."""
    with matmul_precision(tf32):
        s = user_vecs @ item_emb.T
    rows, cols = exclusion_rows(row_ptr, ex_items, users)
    s[rows, cols] = -math.inf
    return s


def topk_answer(user_vecs, item_emb, row_ptr, ex_items, users, k: int, tf32: bool = False):
    """(ids, scores) [b, k] of the masked top-k (the control's answer with
    ``tf32``)."""
    vals, idx = torch.topk(masked_scores(user_vecs, item_emb, row_ptr, ex_items, users, tf32), k, 1)
    return idx, vals


def judge_topk(user_vecs, item_emb, row_ptr, ex_items, users, ids, scores, k: int
               ) -> Tuple[int, float, float]:
    """(wrong ids, widest gap, widest score error) of served answers
    [b, k] against the f32 reference. A wrong id is out of the catalog,
    repeated in its row, or excluded. The gap is how far a served item's
    reference score lies below the reference's k-th best; both it and the
    score error are taken as a share of ‖u‖·max‖i‖, a bound on any score."""
    ref = masked_scores(user_vecs, item_emb, row_ptr, ex_items, users)
    num_items = item_emb.shape[0]
    ids = ids.long()
    bad = (ids < 0) | (ids >= num_items)
    safe = ids.clamp(0, num_items - 1)
    srt = safe.sort(1).values
    dup = torch.zeros_like(bad)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    got = ref.gather(1, safe)
    bad |= torch.isinf(got)
    kth = torch.topk(ref, k, 1).values[:, -1:]
    scale = user_vecs.norm(dim=1, keepdim=True) * item_emb.norm(dim=1).max()
    scale = scale.clamp_min(1e-30)
    ok = ~bad
    gap = torch.where(ok, (kth - got).clamp_min(0) / scale, torch.zeros_like(got))
    err = torch.where(ok, (scores.float() - got).abs() / scale, torch.zeros_like(got))
    return int(bad.sum() + dup.sum()), float(gap.max()), float(err.max())
