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

Sharded checkpoints (``save_state(..., sharded=True)``, which the pipelines
pass when the mesh's model axis is > 1) are ``torch.distributed.checkpoint``
directories with the suffix ``SHARDED_SUFFIX``, where the JAX package writes
orbax directories (``checkpoint.py:52-98``): every rank writes its own row
blocks of the row-sharded leaves (DTensors sharded over ``model``,
replicated over ``data``) and rank 0 the replicated ones. A JAX ``.orbax``
directory is refused by name.
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


def tree_grads(tree):
    """The ``.grad`` of every leaf of a tree of parameters and transposed
    views of them (a model's JAX-layout tree): a view gives its parameter's
    gradient transposed; a parameter without one gives zeros."""
    def leaf(_, view):
        base = view if view._base is None else view._base
        g = base.grad if base.grad is not None else torch.zeros_like(base)
        return g.t() if view._base is not None else g

    return tree_map_with_path(leaf, tree)


@torch.no_grad()
def copy_tree_(tree, src) -> None:
    """Copy ``src`` (a tree of numpy arrays or tensors with the same keys)
    into the leaves of ``tree`` (parameters and views of them)."""
    values = dict(tree_leaves_with_path(src))
    for key, view in tree_leaves_with_path(tree):
        if key not in values:
            raise KeyError(f"params tree has no leaf {key}")
        x = values[key]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        if tuple(x.shape) != tuple(view.shape):
            raise ValueError(f"{key}: shape {tuple(x.shape)}, model has {tuple(view.shape)}")
        view.copy_(x)


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


SHARDED_SUFFIX = ".dcp"


def _dcp_state(state: Any, mesh, row_sharded: Optional[Callable[[str], bool]]) -> Dict[str, Any]:
    """The flat state ``torch.distributed.checkpoint`` reads and writes: host
    copies of the tensor leaves (the leaves ``row_sharded(key)`` names as
    DTensors of their row blocks, sharded over ``model`` and replicated over
    ``data``) and ints as 0-d tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..parallel.mesh import MODEL_AXIS

    flat: Dict[str, Any] = {}
    for key, leaf in tree_leaves_with_path(state):
        if not isinstance(leaf, torch.Tensor):
            flat[key] = torch.tensor(int(leaf), dtype=torch.int64)
            continue
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if row_sharded is not None and row_sharded(key):
            shape = (t.shape[0] * mesh.size(MODEL_AXIS),) + tuple(t.shape[1:])
            t = DTensor.from_local(t, mesh.device_mesh, [Replicate(), Shard(0)],
                                   run_check=False, shape=torch.Size(shape),
                                   stride=torch.empty(shape, device="meta").stride())
        flat[key] = t
    return flat


def save_checkpoint_sharded(path: str, state: Any, mesh,
                            row_sharded: Optional[Callable[[str], bool]] = None) -> None:
    """Write a ``torch.distributed.checkpoint`` directory; called on every rank."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_dcp_state(state, mesh, row_sharded), checkpoint_id=os.path.abspath(path))


def load_checkpoint_sharded(path: str, template: Any, mesh,
                            row_sharded: Optional[Callable[[str], bool]] = None) -> Any:
    """Read a :func:`save_checkpoint_sharded` directory into the structure of
    ``template`` (this rank's row blocks); called on every rank."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    flat = _dcp_state(template, mesh, row_sharded)
    dcp.load(flat, checkpoint_id=os.path.abspath(path))

    def load(key, leaf):
        x = flat[key]
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(leaf, torch.Tensor):
            return x.to(leaf.device, leaf.dtype)
        return int(x)

    return tree_map_with_path(load, template)


def save_state(path_base: str, state: Any, sharded: bool = False, mesh=None,
               row_sharded: Optional[Callable[[str], bool]] = None) -> str:
    """Write one checkpoint at ``path_base``; returns the path. Plain: an
    npz (``.npz``; on a mesh of several ranks rank 0 writes it and the others
    wait). ``sharded=True``: a ``torch.distributed.checkpoint`` directory
    (``SHARDED_SUFFIX``) on a mesh of several ranks, each writing its row
    blocks of the leaves ``row_sharded(key)`` names; called on every rank."""
    multi = mesh is not None and mesh.device_mesh is not None
    if sharded:
        if not multi:
            raise ValueError("a sharded checkpoint needs a mesh of several ranks")
        path = path_base + SHARDED_SUFFIX
        save_checkpoint_sharded(path, state, mesh, row_sharded)
        return path
    path = path_base + ".npz"
    if not multi or mesh.is_coordinator:
        save_checkpoint(path, state)
    if multi:
        from ..parallel.collectives import barrier

        barrier(mesh)
    return path


def load_latest(directory: str, template: Any, prefix: str = "model_", mesh=None,
                row_sharded: Optional[Callable[[str], bool]] = None
                ) -> Tuple[Any, Optional[int]]:
    """The checkpoint with the highest version in its file name (``model_<n>``;
    ``model_final`` above any number), loaded into ``template``; (template,
    None) when there is none. A sharded (``SHARDED_SUFFIX``) checkpoint loads
    on every rank of ``mesh``, ``row_sharded`` naming its sharded leaves as at
    the save; a JAX ``.orbax`` directory is refused."""
    if not os.path.isdir(directory):
        return template, None
    best_path, best_ver = None, -1
    for name in os.listdir(directory):
        m = re.match(rf"{re.escape(prefix)}(final|\d+)\.(npz|orbax|dcp)$", name)
        if not m:
            continue
        ver = 1 << 30 if m.group(1) == "final" else int(m.group(1))
        if ver > best_ver:
            best_ver, best_path = ver, os.path.join(directory, name)
    if best_path is None:
        return template, None
    if best_path.endswith(".orbax"):
        raise ValueError(
            f"{best_path} is an orbax checkpoint of the JAX package; the port reads "
            f"npz files and torch.distributed.checkpoint ({SHARDED_SUFFIX}) directories"
        )
    if best_path.endswith(SHARDED_SUFFIX):
        if mesh is None or mesh.device_mesh is None:
            raise ValueError(f"{best_path} is a sharded checkpoint: load it on its mesh")
        return load_checkpoint_sharded(best_path, template, mesh, row_sharded), best_ver
    return load_checkpoint(best_path, template), best_ver
