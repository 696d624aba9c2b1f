"""Parallelism over ``torch.distributed``: the dp × fsdp × tp and dp × sp
meshes (and the multi-slice layout), the logical-axis sharding rules,
ZeRO's flat buckets and gradient wires, and sequence parallelism (the
port of ``dlrover_tpu/parallel``'s mesh, sharding and sequence
modules)."""

from dlrover_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES,
    Mesh,
    MeshConfig,
    axis_crosses_dcn,
    build_mesh,
    data_axes,
)
from dlrover_tpu_torch.parallel.sequence import (  # noqa: F401
    ring_attention,
    ulysses_attention,
)
