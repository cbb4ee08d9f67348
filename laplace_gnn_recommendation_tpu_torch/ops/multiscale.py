"""The LightGCN multi-scale loop and its self-adjoint whole-loop backward —
the port of the JAX package's ``ops/multiscale.py:37-94``.

One diffusion step is the stacked linear map M(u, i) = (Ã·i, Ãᵀ·u). Its two
directions are each other's transpose, so M is self-adjoint, and so is the
whole loop L = (1/(K+1))·Σ_{k=0}^{K} M^k: the vector-Jacobian product of L
is L applied to the cotangents. :func:`self_adjoint_multiscale` carries that
as one ``torch.autograd.Function`` around the loop: its forward runs
:func:`multiscale_loop` without recording a graph, its backward runs it
once more on the cotangents, and it saves nothing but the operand (the map
is linear). The kernel tier (``ops/spmm_pallas.py``) trains through it, so
its backward launches the same kernel as its forward; the plain tier
(``ops/spmm.py``) keeps ordinary autograd. Each pass of the loop, forward
and backward (the latter on autograd's thread), is one ``propagate`` device
span of ``utils/profiling.tracer``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..utils.profiling import tracer


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


def dense_cotangent(g: torch.Tensor) -> torch.Tensor:
    """A cotangent as the kernels take it: contiguous f32 on a 16-byte
    aligned base. Autograd may hand over an expanded tensor (the cotangent
    of a ``sum()``), a strided one (of a slice), or the zeros it
    materializes for an unused output."""
    g = g.to(torch.float32).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    return g


class _SelfAdjointLoop(torch.autograd.Function):
    """L(u₀, i₀) with backward L(g_u, g_i) (JAX ``multiscale.py:80-93``)."""

    @staticmethod
    def forward(ctx, propagate, operand, num_iterations, user_emb0, item_emb0):
        ctx.propagate, ctx.operand, ctx.num_iterations = propagate, operand, num_iterations
        with tracer.span("propagate", device=True):
            return multiscale_loop(propagate, operand, user_emb0, item_emb0, num_iterations)

    @staticmethod
    def backward(ctx, g_u, g_i):
        with tracer.span("propagate", device=True):
            gu0, gi0 = multiscale_loop(ctx.propagate, ctx.operand, dense_cotangent(g_u),
                                       dense_cotangent(g_i), ctx.num_iterations)
        return None, None, None, gu0, gi0


def self_adjoint_multiscale(
    propagate: Callable,
    operand,
    user_emb0: torch.Tensor,
    item_emb0: torch.Tensor,
    num_iterations: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-scale K-loop whose backward is one more forward of the loop on
    the cotangents (JAX ``multiscale.py:55-94``). ``operand`` is the
    adjacency in whatever layout ``propagate`` takes; it is never a
    trainable."""
    return _SelfAdjointLoop.apply(propagate, operand, num_iterations, user_emb0, item_emb0)
