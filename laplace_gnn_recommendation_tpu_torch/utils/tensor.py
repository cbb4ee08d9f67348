"""1-D set ops and ragged→dense padding helpers — the port's copy of the JAX
package's ``utils/tensor.py`` (reference ``utils/tensor.py:8-61``), in
numpy. The hot paths never build ragged lists (the samplers emit dense
grids), so these serve host-side tooling and tests.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np


def intersection_1d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elements present in both arrays (reference ``utils/tensor.py:8-14``)."""
    return np.intersect1d(np.asarray(a), np.asarray(b))


def difference_1d(a: np.ndarray, b: np.ndarray, assume_unique: bool = False) -> np.ndarray:
    """Elements of ``a`` not in ``b``, in ``a``'s order (a top-k order must
    survive, reference ``utils/metrics_lightgcn.py:139-142``)."""
    a = np.asarray(a)
    return a[~np.isin(a, np.asarray(b), assume_unique=assume_unique)]


def flatten(nested: Sequence[Sequence]) -> list:
    """List-of-lists flatten (reference ``utils/flatten.py:4-5``)."""
    return [item for sub in nested for item in sub]


def padded_stack(
    arrays: List[np.ndarray],
    side: str = "right",
    value: Union[int, float] = 0,
) -> np.ndarray:
    """Stack 1-D/2-D arrays, padding the last dim to the longest
    (reference ``utils/tensor.py:24-61``)."""
    full = max(int(np.asarray(x).shape[-1]) for x in arrays)
    out = []
    for x in arrays:
        x = np.asarray(x)
        pad = full - x.shape[-1]
        if pad > 0:
            widths = [(0, 0)] * (x.ndim - 1) + ([(pad, 0)] if side == "left" else [(0, pad)])
            x = np.pad(x, widths, constant_values=value)
        out.append(x)
    return np.stack(out, axis=0)
