"""LightGCN (https://arxiv.org/abs/2002.02126) — counterpart of the JAX
package's ``models/lightgcn.py``.

The model is two embedding tables; the forward pass is the K-hop
multi-scale diffusion, dispatched on the propagation operand's type, and
``bpr_loss`` is the training objective (JAX ``models/lightgcn.py:101-139``).
The kernel and dense tiers differentiate through the self-adjoint loop of
``ops/multiscale.py``, the plain tier through ordinary autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data.graph import BipartiteGraph
from ..ops.spmm import lightgcn_propagate
from ..ops.spmm_dense import DenseAdjacency, lightgcn_propagate_dense
from ..ops.spmm_pallas import PallasGraph, lightgcn_propagate_pallas


@dataclass
class LightGCNParams:
    """E⁰ tables (reference ``model/lightgcn.py:36-44``)."""

    user_emb: torch.Tensor  # f32 [U, D]
    item_emb: torch.Tensor  # f32 [I, D]


def init_lightgcn(
    num_users: int,
    num_items: int,
    embedding_dim: int,
    std: float = 0.1,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> LightGCNParams:
    """normal(0, std) init on ``device`` (reference ``model/lightgcn.py:
    43-44``); ``generator`` defaults to one on ``device`` seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=generator, device=dev, dtype=torch.float32)
    return LightGCNParams(
        user_emb=torch.randn((num_users, embedding_dim), **kw) * std,
        item_emb=torch.randn((num_items, embedding_dim), **kw) * std,
    )


def lightgcn_params_from_jax(
    user_emb: np.ndarray, item_emb: np.ndarray, device="cuda"
) -> LightGCNParams:
    """Carry E⁰ tables over from the JAX package (numpy arrays, e.g.
    ``np.asarray(params.user_emb)``) onto ``device``."""
    dev = resolve_device(device)
    return LightGCNParams(
        user_emb=torch.tensor(np.asarray(user_emb, np.float32), device=dev),
        item_emb=torch.tensor(np.asarray(item_emb, np.float32), device=dev),
    )


def lightgcn_adam_state_from_jax(mu, nu, count: int, device="cuda"):
    """Carry an ``optax.adam`` state of the JAX LightGCN pipeline over:
    ``mu`` and ``nu`` are (user, item) pairs of numpy arrays, or objects
    with ``user_emb``/``item_emb`` (the optax state's own moments), and
    ``count`` its update count. Returns the port's Adam state
    (``train/adam.py``) on ``device``."""
    from ..train.adam import ScaleByAdamState, ScaleByScheduleState

    def pair(m):
        if hasattr(m, "user_emb"):
            m = (m.user_emb, m.item_emb)
        return lightgcn_params_from_jax(np.asarray(m[0]), np.asarray(m[1]), device)

    count = int(count)
    return (ScaleByAdamState(count=count, mu=pair(mu), nu=pair(nu)),
            ScaleByScheduleState(count=count))


def lightgcn_forward(
    params: LightGCNParams,
    graph: Union[BipartiteGraph, PallasGraph, DenseAdjacency],
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(users_final, users_0, items_final, items_0) — the contract of the
    reference ``model/lightgcn.py:46-80``. A :class:`PallasGraph` runs the
    segment-sum kernel, a :class:`DenseAdjacency` the dense tier's bf16
    products, a :class:`BipartiteGraph` the plain tier."""
    if isinstance(graph, PallasGraph):
        users_final, items_final = lightgcn_propagate_pallas(
            graph, params.user_emb, params.item_emb, num_iterations
        )
    elif isinstance(graph, DenseAdjacency):
        users_final, items_final = lightgcn_propagate_dense(
            graph, params.user_emb, params.item_emb, num_iterations
        )
    elif isinstance(graph, BipartiteGraph):
        users_final, items_final = lightgcn_propagate(
            graph, params.user_emb, params.item_emb, num_iterations
        )
    else:
        raise TypeError(f"unsupported propagation operand {type(graph).__name__}")
    return users_final, params.user_emb, items_final, params.item_emb


def bpr_loss(
    users_emb_final: torch.Tensor,
    users_emb_0: torch.Tensor,
    pos_items_emb_final: torch.Tensor,
    pos_items_emb_0: torch.Tensor,
    neg_items_emb_final: torch.Tensor,
    neg_items_emb_0: torch.Tensor,
    lambda_val: float,
    variant: str = "canonical",
) -> torch.Tensor:
    """Bayesian Personalized Ranking loss (JAX ``models/lightgcn.py:101-139``).

    ``canonical``: -mean(logsigmoid(pos - neg)) + λ·(‖E⁰ rows‖²);
    ``legacy``: -mean(softplus(pos - neg)) + reg, the reference's sign quirk
    (``utils/metrics_lightgcn.py:43``), whose loss goes negative by design.
    As in the JAX package and the reference, the rank term is a batch MEAN
    and the regulariser a batch SUM, so the effective λ grows with the
    batch size (λ_eff ≈ λ·B)."""
    reg = lambda_val * (
        users_emb_0.pow(2).sum() + pos_items_emb_0.pow(2).sum() + neg_items_emb_0.pow(2).sum()
    )
    pos_scores = (users_emb_final * pos_items_emb_final).sum(-1)
    neg_scores = (users_emb_final * neg_items_emb_final).sum(-1)
    diff = pos_scores - neg_scores
    if variant == "legacy":
        rank_term = -F.softplus(diff).mean()
    else:
        rank_term = -F.logsigmoid(diff).mean()
    return rank_term + reg
