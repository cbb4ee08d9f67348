"""Device mesh, hand-written collectives and rank spawning over
``torch.distributed`` (the port of the JAX package's ``parallel/``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    build_mesh,
    distributed_init,
    round_up,
    shard_rows_pad,
)
