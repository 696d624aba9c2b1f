"""Parallelism over ``torch.distributed``: the dp × sp mesh and sequence
parallelism (the port of ``dlrover_tpu/parallel``'s mesh and sequence
modules)."""

from dlrover_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES,
    Mesh,
    MeshConfig,
    build_mesh,
)
from dlrover_tpu_torch.parallel.sequence import (  # noqa: F401
    ring_attention,
    ulysses_attention,
)
