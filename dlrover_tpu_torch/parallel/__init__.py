"""Parallelism over ``torch.distributed``: the dp × fsdp × tp and dp × sp
meshes, the logical-axis sharding rules, and sequence parallelism (the
port of ``dlrover_tpu/parallel``'s mesh, sharding and sequence
modules)."""

from dlrover_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES,
    Mesh,
    MeshConfig,
    build_mesh,
    data_axes,
)
from dlrover_tpu_torch.parallel.sequence import (  # noqa: F401
    ring_attention,
    ulysses_attention,
)
