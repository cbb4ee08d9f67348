"""laplace_gnn_recommendation_tpu_torch — the PyTorch/CUDA port of
``laplace_gnn_recommendation_tpu`` for NVIDIA Hopper (H100, ``sm_90a``).

The module layout and public names mirror the JAX package, so each
counterpart sits at the same path. Plain tensor code is PyTorch; every
Pallas kernel of the JAX package on a ported path is a CUDA C++ kernel under
``csrc/``, built at first use by :mod:`._build` and bound with ``ctypes``.
Each kernel wrapper keeps a plain PyTorch version of the same function
beside it: it runs that version for tensors on the CPU and launches the
kernel (or raises) for tensors on the card.

The port imports ``torch`` and numpy, never ``jax`` and nothing of the JAX
package. Entry points take ``device=`` (default ``"cuda"``) and raise when
asked for the card on a host without one (:func:`resolve_device`).

Ported so far: LightGCN inference and retrieval serving — graph build,
K-hop propagation (segment-sum kernel), top-k retrieval (f32 and int8
streaming kernels), eval metrics, artifact export and ``RetrievalServer``
— and LightGCN training: BPR sampling on the device, ``bpr_loss``, the
self-adjoint backward through the segment-sum kernel, Adam under the
staircase decay, checkpoint/resume and the ``train`` loop; the dense tier and
the heterogeneous SAGE ranking stack (sampler, model, training,
``RankingServer``); PinSAGE (random-walk sampler, model, lazy sparse Adam,
training with HITS@k) and the artifacts path (ETL, MovieLens
preprocessing, training from artifacts, the submission writer).
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; raises
    rather than falling back to the CPU when the card is asked for and
    there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
