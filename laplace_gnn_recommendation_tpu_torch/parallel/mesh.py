"""The 2-D device mesh over ``torch.distributed`` — the port of the JAX
package's ``parallel/mesh.py``.

The JAX package is single-controller: one process sees every device and XLA
inserts the collectives from sharding annotations. The port follows
PyTorch's idiom instead: one process per GPU (``torchrun``, or spawned ranks
in tests), a 2-D ``DeviceMesh`` with dims

* ``data``  — data parallelism over user batches (DP),
* ``model`` — row-sharded embedding tables, sharded SpMM destination rows,
  sharded top-k item partitions (model parallelism),

and the collectives written out by hand (``parallel/collectives.py``). Every
public function with a ``mesh=`` argument is called on every rank. Rank
``r`` sits at (data ``r // M``, model ``r % M``), the row-major layout of the
JAX ``build_mesh``'s device reshape.

A 1×1 mesh needs no process group: its collectives are identities, so every
sharded function also runs unmodified on one device, as in the JAX package.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _launched() -> bool:
    """Whether torchrun (or an equivalent launcher) started this process as
    one of several ranks."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` unless ``device`` says
    otherwise; raises when that card does not exist."""
    if device is not None:
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = resolve_device(f"cuda:{local}")
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={local} but only {torch.cuda.device_count()} "
                           "CUDA devices are visible")
    return dev


def distributed_init(init_method: Optional[str] = None, device=None) -> bool:
    """Join the process group when launched as one of several ranks.

    Returns True when the default process group is (already) initialized.
    Launch detection: torchrun's ``RANK`` and ``WORLD_SIZE`` > 1 (in place of
    the JAX coordinator variables). The rendezvous is ``init_method``, by
    default ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``); a ``file://``
    path serves launches that must not take a port. A single-process run is
    a no-op returning False. A launched rank that cannot join raises: the
    port runs one process per card, so carrying on alone would make each
    card a full-size run of its own, each writing the same files. The
    backend is NCCL for a card, gloo for the CPU (``device``, default this
    rank's card)."""
    if dist.is_available() and dist.is_initialized():
        return True
    if not _launched():
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or "env://",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
    )
    return True


@dataclass
class Mesh:
    """This rank's view of the (data, model) mesh: the axis sizes, its
    coordinates, its device, and the ``DeviceMesh`` whose per-axis process
    groups carry the collectives (None on a 1×1 mesh)."""

    shape: dict
    device: torch.device
    coords: dict = field(default_factory=lambda: {DATA_AXIS: 0, MODEL_AXIS: 0})
    device_mesh: Optional[object] = None

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None when the
        axis has one member)."""
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    @property
    def backend(self) -> Optional[str]:
        """The process group's backend (``nccl`` or ``gloo``); None on a
        mesh of one rank."""
        return dist.get_backend() if self.device_mesh is not None else None

    @property
    def is_coordinator(self) -> bool:
        """Rank 0 of the world: the one that writes shared files."""
        return self.device_mesh is None or dist.get_rank() == 0

    def row_range(self, n_rows: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's row block of an ``n_rows`` table sharded
        over ``model`` (``n_rows`` divides the axis)."""
        parts = self.shape[MODEL_AXIS]
        assert n_rows % parts == 0, (n_rows, parts)
        per = n_rows // parts
        lo = self.coords[MODEL_AXIS] * per
        return lo, lo + per

    def batch_slice(self, n: int) -> slice:
        """This rank's slice of a length-``n`` batch split over ``data``
        (contiguous, the first ``n % D`` slices one longer)."""
        d, r = self.shape[DATA_AXIS], self.coords[DATA_AXIS]
        per, extra = divmod(n, d)
        lo = r * per + min(r, extra)
        return slice(lo, lo + per + (1 if r < extra else 0))


def build_mesh(data_axis: int = -1, model_axis: int = 1, device=None) -> Mesh:
    """The 2-D ``(data, model)`` mesh over the ranks of the default process
    group, or over this process alone when there is none.

    ``-1`` on either axis absorbs the remaining ranks. With one rank this
    degenerates to a 1×1 mesh, which needs no process group. ``device``
    defaults to this rank's card (``cuda:{LOCAL_RANK}``)."""
    dev = rank_device(device)
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if data_axis == -1 and model_axis == -1:
        data_axis, model_axis = n, 1
    elif data_axis == -1:
        assert n % model_axis == 0, (n, model_axis)
        data_axis = n // model_axis
    elif model_axis == -1:
        assert n % data_axis == 0, (n, data_axis)
        model_axis = n // data_axis
    if data_axis * model_axis != n:
        raise ValueError(f"mesh {data_axis}x{model_axis} != {n} ranks")
    shape = {DATA_AXIS: data_axis, MODEL_AXIS: model_axis}
    if n == 1:
        return Mesh(shape, dev)
    from torch.distributed.device_mesh import DeviceMesh

    r = dist.get_rank()
    dm = DeviceMesh(dev.type, torch.arange(n).view(data_axis, model_axis),
                    mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(shape, dev, {DATA_AXIS: r // model_axis, MODEL_AXIS: r % model_axis}, dm)


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def shard_rows_pad(n_rows: int, mesh: Mesh) -> int:
    """A row count padded to divide the ``model`` axis. Pad rows are dead
    weight: no edge or lookup references them."""
    return round_up(max(n_rows, 1), mesh.shape[MODEL_AXIS])


def model_parts(mesh: Optional[Mesh]) -> int:
    """The ``model`` axis size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape[MODEL_AXIS]


def data_parts(mesh: Optional[Mesh]) -> int:
    """The ``data`` axis size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape[DATA_AXIS]


def mesh_from_config(mc, device=None) -> Optional[Mesh]:
    """The mesh a pipeline takes when its caller passes none (JAX
    ``lightgcn_pipeline.py:548-558``): under a multi-rank launch, or with an
    explicit non-default axis spec in ``mc`` (a ``MeshConfig``), the mesh
    spans every rank; otherwise None, the single-device run."""
    explicit = mc is not None and (mc.data_axis, mc.model_axis) != (-1, 1)
    launched = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if not (launched or explicit):
        return None
    return build_mesh(mc.data_axis, mc.model_axis, device=device)
