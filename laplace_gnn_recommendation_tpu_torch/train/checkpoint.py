"""Checkpoint / resume — the npz path of the JAX package's
``train/checkpoint.py`` (``save_checkpoint``, ``load_checkpoint``,
``save_state``, ``load_latest``).

A state is a tree of dicts, tuples and dataclasses whose leaves are tensors
or ints (``{"params": LightGCNParams, "opt_state": (ScaleByAdamState,
ScaleByScheduleState)}``). It is written as one npz of the flattened tree
under the JAX package's key names (``['params']/.user_emb``,
``['opt_state']/[0]/.count``, ...), so a checkpoint the JAX ``save_state``
wrote loads here, params and optimizer state both. The port writes the
npz uncompressed. ``load_latest`` keeps the version rule of the JAX
``checkpoint.py:97-116`` (the reference's ``run_submission.py:14-21``).
Sharded (orbax) checkpoints come with the multi-GPU slice.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _join(path: str, part: str) -> str:
    return f"{path}/{part}" if path else part


def tree_map_with_path(fn: Callable, tree, path: str = ""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``; keys in the
    JAX package's format: ``['k']`` for a dict entry, ``[i]`` for a tuple or
    list item, ``.name`` for a dataclass field, joined by ``/``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _join(path, f"[{k!r}]")) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, x, _join(path, f"[{i}]"))
                          for i, x in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), _join(path, f".{f.name}"))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def tree_leaves_with_path(tree) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs of ``tree`` (keys as in :func:`tree_map_with_path`)."""
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda key, leaf: out.append((key, leaf)), tree)
    return out


def tree_clone(tree):
    """A copy of every tensor leaf (the optimizer updates tables in place)."""
    return tree_map_with_path(
        lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            flat[key] = leaf.detach().cpu().numpy()
        else:
            flat[key] = np.asarray(leaf, np.int32 if isinstance(leaf, int) else None)
    return flat


def _unflatten_into(template, flat: Dict[str, np.ndarray]):
    def load(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(flat[key])).to(leaf.device, leaf.dtype)
        return int(flat[key])

    return tree_map_with_path(load, template)


def save_checkpoint(path: str, state: Any) -> None:
    """Write one checkpoint file (npz of the flattened tree)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(state))


def load_checkpoint(path: str, template: Any) -> Any:
    """Load into the structure of ``template``; each tensor leaf comes back
    on the template leaf's device and dtype."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(template, flat)


def save_state(path_base: str, state: Any, sharded: bool = False) -> str:
    """Write one checkpoint at ``path_base`` + ``.npz``; returns the path."""
    if sharded:
        raise NotImplementedError(
            "sharded checkpoints come with the multi-GPU slice of the port"
        )
    path = path_base + ".npz"
    save_checkpoint(path, state)
    return path


def load_latest(directory: str, template: Any, prefix: str = "model_") -> Tuple[Any, Optional[int]]:
    """The checkpoint with the highest version in its file name (``model_<n>``;
    ``model_final`` above any number), loaded into ``template``; (template,
    None) when there is none."""
    if not os.path.isdir(directory):
        return template, None
    best_path, best_ver = None, -1
    for name in os.listdir(directory):
        m = re.match(rf"{re.escape(prefix)}(final|\d+)\.(npz|orbax)$", name)
        if not m:
            continue
        ver = 1 << 30 if m.group(1) == "final" else int(m.group(1))
        if ver > best_ver:
            best_ver, best_path = ver, os.path.join(directory, name)
    if best_path is None:
        return template, None
    if best_path.endswith(".orbax"):
        raise NotImplementedError(
            f"{best_path} is a sharded checkpoint; those come with the multi-GPU slice"
        )
    return load_checkpoint(best_path, template), best_ver
