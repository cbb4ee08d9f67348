"""Device-side negative sampling with positive rejection — the port of the
JAX package's ``ops/sampling.py:23-90`` (the reference's call sites:
``data/lightgcn_loader.py:95-112``, ``run_pipeline_lightgcn.py:40-44``).

Draws come from an explicit ``torch.Generator`` on the tensors' device, so
a run is repeatable from its seed; the JAX package draws from
``jax.random`` keys, and the two streams differ. The draw
(:func:`draw_negative_candidates`) is kept apart from the pick
(:func:`pick_negatives`), which is deterministic, so that the same
candidates give the JAX package's negatives bit for bit.

Semantics kept: T=8 candidate rounds per edge; a candidate that is a
positive of the edge's user (CSR binary search, ``ops/search.py``) is
rejected; the first surviving round wins; a lane whose every round is a
positive keeps its last draw (``sampling.py:58-63``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .search import batched_membership

NUM_TRIES = 8


def uniform_negative_sampling(
    generator: torch.Generator, shape: Tuple[int, ...], num_items: int
) -> torch.Tensor:
    """Uniform int32 item draws with no rejection on the generator's device
    (JAX ``sampling.py:23-29``)."""
    return torch.randint(0, num_items, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int32)


def draw_negative_candidates(
    generator: torch.Generator, num_edges: int, num_items: int,
    num_tries: int = NUM_TRIES,
) -> torch.Tensor:
    """The candidate rounds: int32 [E, num_tries] uniform item ids."""
    return uniform_negative_sampling(generator, (num_edges, num_tries), num_items)


def pick_negatives(
    cands: torch.Tensor,             # int [E, T] candidate item ids
    edge_user: torch.Tensor,         # int [E] users of the sampled edges
    user_row_ptr: torch.Tensor,      # int [U+1] CSR over positive items
    sorted_item_cols: torch.Tensor,  # int [E_all] user-major sorted item ids
    max_degree: int,
) -> torch.Tensor:
    """The first candidate round that is not a positive of its user; the
    last round where every round is (JAX ``sampling.py:50-63``). [E], of
    the candidates' dtype."""
    e, t = cands.shape
    is_pos = batched_membership(
        user_row_ptr, sorted_item_cols, edge_user[:, None], cands, max_degree
    )
    rounds = torch.arange(t, device=cands.device).expand(e, t)
    first_ok = torch.where(is_pos, t, rounds).amin(dim=1)
    pick = torch.where(first_ok < t, first_ok, t - 1)
    return cands.gather(1, pick[:, None])[:, 0]


def structured_negative_sampling(
    generator: torch.Generator,
    edge_user: torch.Tensor,
    user_row_ptr: torch.Tensor,
    sorted_item_cols: torch.Tensor,
    num_items: int,
    max_degree: int,
    num_tries: int = NUM_TRIES,
) -> torch.Tensor:
    """For each edge with user u, j ~ Uniform(items) with (u, j) ∉ E, best
    effort (JAX ``sampling.py:32-63``). int32 [E]."""
    cands = draw_negative_candidates(generator, int(edge_user.shape[0]), num_items, num_tries)
    return pick_negatives(cands, edge_user, user_row_ptr, sorted_item_cols, max_degree)


def sample_bpr_batch(
    generator: torch.Generator,
    edge_user: torch.Tensor,
    edge_item: torch.Tensor,
    num_edges: int,
    batch_size: int,
    user_row_ptr: torch.Tensor,
    sorted_item_cols: torch.Tensor,
    num_items: int,
    max_degree: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``batch_size`` random (user, pos_item, neg_item) triples: edges drawn
    uniformly with replacement from the first ``num_edges`` (never a pad
    slot), then one rejected negative each (JAX ``sampling.py:66-90``)."""
    idx = torch.randint(0, num_edges, (batch_size,), generator=generator,
                        device=generator.device)
    u = edge_user[idx]
    pos = edge_item[idx]
    neg = structured_negative_sampling(
        generator, u, user_row_ptr, sorted_item_cols, num_items, max_degree
    )
    return u, pos, neg
