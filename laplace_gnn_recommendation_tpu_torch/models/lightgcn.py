"""LightGCN (https://arxiv.org/abs/2002.02126) — counterpart of the JAX
package's ``models/lightgcn.py`` (inference; ``bpr_loss`` comes with the
training slice).

The model is two embedding tables; the forward pass is the K-hop
multi-scale diffusion, dispatched on the propagation operand's type.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..data.graph import BipartiteGraph
from ..ops.spmm import lightgcn_propagate
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
        user_emb=torch.from_numpy(np.ascontiguousarray(user_emb, np.float32)).to(dev),
        item_emb=torch.from_numpy(np.ascontiguousarray(item_emb, np.float32)).to(dev),
    )


def lightgcn_forward(
    params: LightGCNParams,
    graph: Union[BipartiteGraph, PallasGraph],
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(users_final, users_0, items_final, items_0) — the contract of the
    reference ``model/lightgcn.py:46-80``. A :class:`PallasGraph` runs the
    segment-sum kernel; a :class:`BipartiteGraph` the plain tier."""
    if isinstance(graph, PallasGraph):
        users_final, items_final = lightgcn_propagate_pallas(
            graph, params.user_emb, params.item_emb, num_iterations
        )
    elif isinstance(graph, BipartiteGraph):
        users_final, items_final = lightgcn_propagate(
            graph, params.user_emb, params.item_emb, num_iterations
        )
    else:
        raise TypeError(f"unsupported propagation operand {type(graph).__name__}")
    return users_final, params.user_emb, items_final, params.item_emb
