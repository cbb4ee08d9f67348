"""Dense-adjacency LightGCN propagation — the port of the JAX package's
``ops/spmm_dense.py``, the tier ``propagation="auto"`` takes wherever

    2 · num_users · num_items · 2 bytes  ≤  dense_bytes_budget

(Ã and Ãᵀ as bf16 dense matrices, built once), as at MovieLens-1M.

One diffusion step is two matrix products, (Ã·bf16(E_i), Ãᵀ·bf16(E_u)),
with bf16 operands and an f32 result (JAX ``jnp.dot(...,
preferred_element_type=f32)``). ``torch.matmul`` of two bf16 tensors returns
bf16, which would compute another function, so the product never keeps a
bf16 output: on the card it is ``torch.mm(..., out_dtype=torch.float32)``
(cuBLAS, f32 accumulation), on the CPU the bf16 operands upcast to f32
(bf16 values are exact in f32, and so is their product). The tier holds no
hand-written kernel: in the JAX package it is a plain XLA ``dot``, outside
any Pallas kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..data.graph import BipartiteGraph

DENSE_BYTES_BUDGET_DEFAULT = 4 << 30  # 4 GiB for A + Aᵀ


@dataclass
class DenseAdjacency:
    """Ã and Ãᵀ as dense bf16 on one device."""

    a: torch.Tensor    # bf16 [U, I] symmetric-normalized adjacency
    a_t: torch.Tensor  # bf16 [I, U] its transpose, materialized
    num_users: int = 0
    num_items: int = 0

    @staticmethod
    def from_graph(g: BipartiteGraph) -> "DenseAdjacency":
        """Build on the graph's device; duplicate (user, item) edges
        accumulate (``np.add.at``), as in the segment-sum tiers."""
        u, i, w, *_ = g.host_arrays()
        a = np.zeros((g.num_users, g.num_items), np.float32)
        np.add.at(a, (u, i), w)
        a_bf16 = torch.from_numpy(a).to(torch.bfloat16)
        return DenseAdjacency(
            a=a_bf16.to(g.device),
            a_t=a_bf16.t().contiguous().to(g.device),
            num_users=g.num_users,
            num_items=g.num_items,
        )


def dense_fits(num_users: int, num_items: int,
               budget: int = DENSE_BYTES_BUDGET_DEFAULT) -> bool:
    return 2 * num_users * num_items * 2 <= budget


def bf16_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b for bf16 ``a`` and ``b`` with an f32 result, accumulated in f32."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def propagate_dense(
    d: DenseAdjacency, user_emb: torch.Tensor, item_emb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One diffusion step: (Ã·E_i, Ãᵀ·E_u), operands in bf16, result f32."""
    new_user = bf16_mm_f32(d.a, item_emb.to(torch.bfloat16))
    new_item = bf16_mm_f32(d.a_t, user_emb.to(torch.bfloat16))
    return new_user, new_item


def lightgcn_propagate_dense(
    d: DenseAdjacency,
    user_emb0: torch.Tensor,
    item_emb0: torch.Tensor,
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-iteration multi-scale mean over the dense pair, trained through the
    self-adjoint loop Function: the bf16 (Ã, Ãᵀ) pair is exactly mutually
    transposed, so the backward is this loop on the cotangents (JAX
    ``spmm_dense.py:81-95``)."""
    from .multiscale import self_adjoint_multiscale

    return self_adjoint_multiscale(
        propagate_dense, d, user_emb0, item_emb0, num_iterations
    )
