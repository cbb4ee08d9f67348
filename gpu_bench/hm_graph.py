"""The H&M-shaped interaction graph, made from the seed on the device.

A frozen rewrite, in torch, of the clustered generator that the port's
bring-up measured H&M shape with (``data/synthetic.latent_bipartite_edges``
with ``bench_hm.py``'s cardinalities): each user draws 1 + Poisson(d - 1)
items; with probability ``in_cluster_p`` an item of the user's own latent
cluster, else any item, each weighted by popularity rank^-alpha. Pairs are
made unique. The result is sorted by (user, item).

Every draw comes from one ``torch.Generator`` in a few large calls, so one
seed gives the same edges on the same card and software.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def generate(p: Dict, gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge_user, edge_item), int64 on the generator's device, sorted by
    (user, item) and unique. ``p`` holds num_users, num_items, avg_degree,
    popularity_alpha, num_clusters, in_cluster_p."""
    dev = gen.device
    nu, ni = int(p["num_users"]), int(p["num_items"])
    nc = int(p["num_clusters"])
    lam = torch.full((nu,), float(p["avg_degree"]) - 1.0, device=dev)
    deg = (1 + torch.poisson(lam, generator=gen)).clamp_(max=ni).long()
    users = torch.repeat_interleave(torch.arange(nu, device=dev), deg)
    total = int(users.numel())
    user_cluster = torch.randint(0, nc, (nu,), generator=gen, device=dev)
    item_cluster = torch.randint(0, nc, (ni,), generator=gen, device=dev)

    ranks = torch.arange(1, ni + 1, dtype=torch.float64, device=dev)
    probs = ranks.pow(-float(p["popularity_alpha"]))
    cdf = probs.cumsum(0)
    u = torch.rand(total, generator=gen, device=dev, dtype=torch.float64)
    items = torch.searchsorted(cdf, u * cdf[-1]).clamp_(max=ni - 1)

    # popularity-weighted draws inside a cluster: the items sorted by
    # (cluster, id), one cumulative mass over them, each cluster a segment
    order = torch.argsort(item_cluster * ni + torch.arange(ni, device=dev))
    mcum = probs[order].cumsum(0)
    mcum0 = torch.cat([mcum.new_zeros(1), mcum])
    counts = torch.bincount(item_cluster, minlength=nc)
    cend = counts.cumsum(0)
    cstart = cend - counts
    inc = torch.rand(total, generator=gen, device=dev) < float(p["in_cluster_p"])
    c = user_cluster[users]
    r = torch.rand(total, generator=gen, device=dev, dtype=torch.float64)
    target = mcum0[cstart[c]] + r * (mcum0[cend[c]] - mcum0[cstart[c]])
    pos = torch.searchsorted(mcum, target)
    pos = torch.minimum(torch.maximum(pos, cstart[c]), (cend[c] - 1).clamp(min=0))
    take = inc & (counts[c] > 0)
    items = torch.where(take, order[pos], items)

    key = torch.unique(users * ni + items)
    return key // ni, key % ni


def split_mask(num_edges: int, gen: torch.Generator, train_share: float = 0.8) -> torch.Tensor:
    """Bool [E] on the generator's device: a random ``train_share`` of the
    edges (the rest are the held-out 10/10)."""
    perm = torch.randperm(num_edges, generator=gen, device=gen.device)
    mask = torch.zeros(num_edges, dtype=torch.bool, device=gen.device)
    mask[perm[: int(round(train_share * num_edges))]] = True
    return mask
