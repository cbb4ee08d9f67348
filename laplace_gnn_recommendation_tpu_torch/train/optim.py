"""Row-sparse (lazy) Adam for embedding tables — the port of the JAX
package's ``train/optim.py`` (the reference's ``SparseAdam`` variant,
``pinsage/model_sparse.py:104-127``): only the rows a step touched have
their moments decayed and their values moved, under one global ``count``
(torch ``SparseAdam``'s lazy semantics).

The touched rows come from the batch layout (every item id a PinSAGE batch
references sits in ``blocks[0].src_ids``); pad slots are marked by
``row_mask`` and dropped. The valid rows must be unique, as the sampler
makes them: the moments are written with ``index_copy_`` and the table moved
with ``index_add_``, each row once, so no float atomic ever meets a repeat
and a step gives the same bits every time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch


@dataclass
class SparseAdamState:
    """First and second moments (only touched rows evolve) and the global
    step count, kept on the host."""

    m: torch.Tensor   # [N, D] or [N]
    v: torch.Tensor
    count: int


def init_sparse_adam_state(table: torch.Tensor) -> SparseAdamState:
    return SparseAdamState(m=torch.zeros_like(table), v=torch.zeros_like(table), count=0)


def _kept(row_mask: Union[torch.Tensor, np.ndarray], dev: torch.device) -> torch.Tensor:
    """Positions of the valid rows. A mask given as a host array costs the
    card nothing (the positions go up through pinned memory, queued behind
    its work); one given as a tensor on the card is read back."""
    if isinstance(row_mask, torch.Tensor):
        return torch.nonzero(row_mask.reshape(-1)).reshape(-1).to(dev)
    keep = torch.from_numpy(np.flatnonzero(np.asarray(row_mask)))
    if dev.type == "cuda":
        return keep.pin_memory().to(dev, non_blocking=True)
    return keep


@torch.no_grad()
def sparse_rows_adam_update(
    table: torch.Tensor,          # [N, D] (or [N] for 1-D bias tables)
    state: SparseAdamState,
    rows: torch.Tensor,           # int [R] touched row ids (may contain pads)
    row_mask,                     # bool [R] valid rows: a tensor or a host array
    grad_rows: torch.Tensor,      # [R, D] (or [R]) gradient w.r.t. those rows
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, SparseAdamState]:
    """One lazy-Adam step on the touched rows, in place on ``table``,
    ``state.m`` and ``state.v``. Returns (table, state) with the count
    advanced, as the JAX function does."""
    count = state.count + 1
    keep = _kept(row_mask, table.device)
    r = rows.reshape(-1).to(table.device).long().index_select(0, keep)
    g = grad_rows.index_select(0, keep)
    m_new = b1 * state.m.index_select(0, r) + (1 - b1) * g
    v_new = b2 * state.v.index_select(0, r) + (1 - b2) * g ** 2
    # the bias corrections in the table's dtype, as JAX computes them
    c = torch.tensor(float(count), dtype=table.dtype)
    m_hat = m_new / float(1 - torch.tensor(b1, dtype=table.dtype) ** c)
    v_hat = v_new / float(1 - torch.tensor(b2, dtype=table.dtype) ** c)
    delta = lr * m_hat / (torch.sqrt(v_hat) + eps)
    state.m.index_copy_(0, r, m_new)
    state.v.index_copy_(0, r, v_new)
    table.index_add_(0, r, -delta)
    return table, SparseAdamState(state.m, state.v, count)
