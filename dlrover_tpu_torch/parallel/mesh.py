"""The device mesh over ``torch.distributed`` process groups.

Port of ``dlrover_tpu/parallel/mesh.py``. The JAX package lays every
parallelism axis on one ``jax.sharding.Mesh`` of devices; here a mesh is
the same six named axes over the ranks of the ``torch.distributed``
world, one rank a process, laid out row-major in the JAX axis order
``("dp", "pp", "ep", "fsdp", "sp", "tp")`` (the JAX ``build_mesh``
reshapes its device list the same way off a TPU topology), so sp is the
innermost of the ported axes: the ranks of one sp group are adjacent.

Ported: data parallelism (``dp``, parameters replicated) and sequence
parallelism (``sp``, ``parallel/sequence.py``). sp above 1 gets its
process groups, formed by every rank in the same order: the sequence
collectives run over them. dp is a coordinate only (the parameters are
replicated on both axes, so the step's all-reduces run over the whole
world and need no group of their own). The other axes
above 1 raise: ``fsdp`` and ``tp`` wait for ROADMAP A9, ``pp`` and
``ep`` for A16 (pipeline, MoE).
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch.distributed as dist

MESH_AXES = ("dp", "pp", "ep", "fsdp", "sp", "tp")
#: the ROADMAP item that ports each other axis
UNPORTED_AXES = {"fsdp": "A9", "tp": "A9", "pp": "A16", "ep": "A16"}


@dataclass
class MeshConfig:
    """Sizes for each mesh axis; -1 means "absorb remaining devices"."""

    dp: int = -1
    pp: int = 1
    ep: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    # DCN-connected slices (the JAX multi-slice layout); the port runs 1
    num_slices: int = 1

    def resolved_sizes(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        wildcard = [k for k, v in sizes.items() if v == -1]
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if n_devices % fixed:
            raise ValueError(
                f"mesh sizes {sizes} do not divide device count {n_devices}"
            )
        if len(wildcard) > 1:
            raise ValueError("at most one axis may be -1")
        if wildcard:
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh sizes {sizes} (={fixed}) != device count {n_devices}"
            )
        return sizes

    @classmethod
    def from_dict(cls, d: Dict) -> "MeshConfig":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


def check_ported(sizes: Dict[str, int], num_slices: int = 1) -> None:
    """Raise ``NotImplementedError`` for an axis above 1 the port does not
    run, naming the ROADMAP item that ports it."""
    for axis, item in UNPORTED_AXES.items():
        if sizes.get(axis, 1) > 1:
            what = ("fully sharded data parallelism and tensor parallelism"
                    if item == "A9" else "pipeline and expert parallelism")
            raise NotImplementedError(
                f"mesh axis {axis}={sizes[axis]}: {what} are not ported "
                f"yet (ROADMAP {item}); the port's mesh runs dp x sp")
    if num_slices != 1:
        raise NotImplementedError(
            f"num_slices={num_slices}: the multi-slice layout is not "
            "ported yet (ROADMAP A9)")


def rank_coords(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """The mesh coordinate of ``rank``: row-major over ``MESH_AXES``, tp
    fastest."""
    coords = {}
    for axis in reversed(MESH_AXES):
        coords[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return {a: coords[a] for a in MESH_AXES}


def coords_rank(coords: Dict[str, int], sizes: Dict[str, int]) -> int:
    """``rank_coords`` inverted."""
    rank = 0
    for axis in MESH_AXES:
        rank = rank * sizes[axis] + coords.get(axis, 0)
    return rank


def axis_groups(sizes: Dict[str, int], axis: str) -> List[List[int]]:
    """Every group of ranks along ``axis`` (the ranks that differ only in
    their ``axis`` coordinate), each in coordinate order, the groups in
    the order of their first rank."""
    world = math.prod(sizes.values())
    groups = []
    for rank in range(world):
        c = rank_coords(rank, sizes)
        if c[axis] == 0:
            groups.append([coords_rank(dict(c, **{axis: i}), sizes)
                           for i in range(sizes[axis])])
    return groups


class Mesh:
    """The mesh as this rank sees it: ``shape`` (axis → size, as the JAX
    ``Mesh.shape``), this rank's coordinates, the ranks of its group along
    each axis and, when sp is above 1, its sp process group."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.shape = {a: int(sizes.get(a, 1)) for a in MESH_AXES}
        self.rank = rank
        self.coords = rank_coords(rank, self.shape)
        self._groups = dict(groups or {})

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's group along ``axis``, in
        coordinate order."""
        return [coords_rank(dict(self.coords, **{axis: i}), self.shape)
                for i in range(self.shape[axis])]

    def group(self, axis: str):
        """The process group of this rank's ``axis`` group: sp's, or None
        when the axis is 1 (no collective runs over it). Only sp has
        one."""
        if self.shape[axis] == 1:
            return None
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def build_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh over the ``torch.distributed`` world (one process, no
    group: a world of 1). Every rank calls it, in the same order as its
    other group-forming calls: sp above 1 forms all its groups."""
    config = config or MeshConfig()
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    check_ported({a: getattr(config, a) for a in MESH_AXES},
                 config.num_slices)
    sizes = config.resolved_sizes(world)
    check_ported(sizes)
    groups = {}
    if sizes["sp"] > 1:
        for members in axis_groups(sizes, "sp"):
            g = dist.new_group(members)
            if rank in members:
                groups["sp"] = g
    return Mesh(sizes, rank, groups)
