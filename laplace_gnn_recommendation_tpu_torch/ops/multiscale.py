"""The LightGCN multi-scale loop (forward of the JAX package's
``ops/multiscale.py``). The self-adjoint ``autograd.Function`` around it
comes with the training slice."""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def multiscale_loop(
    propagate: Callable,
    operand,
    user_emb0: torch.Tensor,
    item_emb0: torch.Tensor,
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1/(K+1))·Σ_k M^k applied to (u₀, i₀), M one ``propagate`` step."""
    acc_u, acc_i = user_emb0, item_emb0
    eu, ei = user_emb0, item_emb0
    for _ in range(num_iterations):
        eu, ei = propagate(operand, eu, ei)
        acc_u = acc_u + eu
        acc_i = acc_i + ei
    scale = 1.0 / (num_iterations + 1)
    return acc_u * scale, acc_i * scale
