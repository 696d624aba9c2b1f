"""The device mesh over ``torch.distributed`` process groups.

Port of ``dlrover_tpu/parallel/mesh.py``. The JAX package lays every
parallelism axis on one ``jax.sharding.Mesh`` of devices; here a mesh is
the same six named axes over the ranks of the ``torch.distributed``
world, one rank a process, laid out row-major in the JAX axis order
``("dp", "pp", "ep", "fsdp", "sp", "tp")`` (the JAX ``build_mesh``
reshapes its device list the same way off a TPU topology), so sp is the
innermost of the ported axes: the ranks of one sp group are adjacent.

Ported: data parallelism (``dp``), fully sharded data parallelism
(``fsdp``: the parameters' ``embed`` dim cut over it, gathered on use),
tensor parallelism (``tp``: heads, MLP columns and the vocabulary cut
over it, Megatron style) and sequence parallelism (``sp``,
``parallel/sequence.py``), in any combination: the JAX "3D + sequence"
rules. The batch is cut over ``data_axes()``, dp and fsdp jointly, and
the sequence over sp. Under dp × sp alone the parameters are
replicated: sp gets its process groups (the sequence collectives run
over them) and the step's all-reduces run over the whole world. When
fsdp or tp is above 1 every combination of dp, fsdp, sp and tp gets its
groups (``group(("dp", "fsdp"))``: the ranks that differ only in those
coordinates): the parameter collectives run over fsdp and tp, the
sequence collectives over sp, each gradient's sum over the axes where
its contributions differ (``train/train_step.py``).

The multi-slice layout (``MeshConfig.num_slices``, the JAX hybrid
mesh): the ranks are laid out slice-major, dp outermost, so with ``dp %
num_slices == 0`` slice ``s`` is the contiguous block of ranks ``[s·W/n,
(s+1)·W/n)`` (the JAX CPU emulation's order: a row-major reshape of the
device list). The JAX package reads a device's ``slice_index``; a rank
here has none, so the layout decides which slice it is in, and
``axis_crosses_dcn`` reads the layout: dp crosses slices when
``num_slices`` is above 1, every other axis stays inside one. Where the
workers know their node (``GraftEnv.NODE_RANK``, which the elastic
agent sets), a slice whose ranks lie on two nodes raises
(``check_slice_nodes``), as the JAX real-hardware path lets a
misconfiguration raise.

Refused, naming its ROADMAP item: ``pp`` and ``ep`` above 1 (A16:
pipeline, MoE).
"""

import itertools
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch.distributed as dist

from dlrover_tpu_torch.common.constants import GraftEnv

MESH_AXES = ("dp", "pp", "ep", "fsdp", "sp", "tp")
#: the ROADMAP item that ports each other axis
UNPORTED_AXES = {"pp": "A16", "ep": "A16"}
#: the axes whose groups, in every combination, a mesh with fsdp or tp
#: above 1 forms: the sharded layouts' and the sequence collectives run
#: over them
GROUP_AXES = ("dp", "fsdp", "sp", "tp")


@dataclass
class MeshConfig:
    """Sizes for each mesh axis; -1 means "absorb remaining devices"."""

    dp: int = -1
    pp: int = 1
    ep: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    # DCN-connected slices (the JAX multi-slice layout): dp outermost,
    # cut over them
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


def check_ported(sizes: Dict[str, int]) -> None:
    """Raise ``NotImplementedError`` for an axis above 1 the port does not
    run, naming the ROADMAP item that ports it."""
    for axis, item in UNPORTED_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={sizes[axis]}: pipeline and expert "
                f"parallelism are not ported yet (ROADMAP {item}); the "
                "port's mesh runs dp x fsdp x sp x tp")


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


Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _members(coords: Dict[str, int], sizes: Dict[str, int],
             axes: Tuple[str, ...]) -> List[int]:
    """The ranks that share ``coords`` off ``axes``, row-major over
    ``axes`` in mesh order."""
    axes = tuple(a for a in MESH_AXES if a in axes)
    return [coords_rank(dict(coords, **dict(zip(axes, idx))), sizes)
            for idx in itertools.product(*(range(sizes[a]) for a in axes))]


def axis_groups(sizes: Dict[str, int], axis: Axes) -> List[List[int]]:
    """Every group of ranks along ``axis`` (an axis, or several: the ranks
    that differ only in those coordinates), each in coordinate order, the
    groups in the order of their first rank."""
    axes = _axes(axis)
    world = math.prod(sizes.values())
    groups = []
    for rank in range(world):
        c = rank_coords(rank, sizes)
        if all(c[a] == 0 for a in axes):
            groups.append(_members(c, sizes, axes))
    return groups


def data_axes() -> tuple:
    """Mesh axes over which the global batch is sharded."""
    return ("dp", "fsdp")


def _key(shape: Dict[str, int], axes: Axes) -> Tuple[str, ...]:
    """The axes of ``axes`` above 1, in mesh order: groups are formed and
    looked up by it."""
    axes = _axes(axes)
    return tuple(a for a in MESH_AXES if a in axes and shape[a] > 1)


def check_slices(sizes: Dict[str, int], num_slices: int) -> None:
    """Raise ``ValueError`` unless dp divides over ``num_slices``, as the
    JAX ``build_mesh`` does."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if sizes["dp"] % num_slices:
        raise ValueError(f"dp={sizes['dp']} must be divisible by "
                         f"num_slices={num_slices}")


def slice_of(rank: int, world: int, num_slices: int) -> int:
    """The slice rank ``rank`` lies in: slice-major, ``world //
    num_slices`` ranks a slice."""
    return rank // (world // num_slices)


class Mesh:
    """The mesh as this rank sees it: ``shape`` (axis → size, as the JAX
    ``Mesh.shape``), this rank's coordinates, the ranks of its group along
    each axis and, when sp is above 1, its sp process group;
    ``num_slices``, the DCN slices dp is cut over."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None,
                 num_slices: int = 1):
        self.shape = {a: int(sizes.get(a, 1)) for a in MESH_AXES}
        self.rank = rank
        self.coords = rank_coords(rank, self.shape)
        self._groups = dict(groups or {})
        check_slices(self.shape, num_slices)
        self.num_slices = num_slices

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    @property
    def sharded(self) -> bool:
        """True when fsdp or tp is above 1: the parameters are cut."""
        return self.shape["fsdp"] > 1 or self.shape["tp"] > 1

    def ranks(self, axis: Axes) -> List[int]:
        """The global ranks of this rank's group along ``axis`` (one axis
        or several), in coordinate order."""
        return _members(self.coords, self.shape, _axes(axis))

    def group(self, axis: Axes):
        """The process group of this rank's group along ``axis`` (one
        axis, or several jointly), or None when every one of them is 1 (no
        collective runs over it). sp has groups; so, when the parameters
        are sharded, has every combination of dp, fsdp, sp and tp."""
        key = _key(self.shape, axis)
        if not key:
            return None
        return self._groups[key]

    def size_of(self, axis: Axes) -> int:
        """The number of ranks in this rank's group along ``axis``."""
        return math.prod(self.shape[a] for a in _axes(axis))

    def __repr__(self):
        slices = (f", num_slices={self.num_slices}" if self.num_slices > 1
                  else "")
        return f"Mesh({self.shape}, rank={self.rank}{slices})"


def axis_crosses_dcn(mesh: Mesh, axis: str) -> bool:
    """True when stepping along ``axis`` can change slice: a collective
    over ``axis`` crosses DCN. One pencil along ``axis`` through each
    point of the other axes' grid, each rank's slice from the layout
    (``slice_of``)."""
    if mesh.shape.get(axis, 1) <= 1 or mesh.num_slices <= 1:
        return False
    world = mesh.size
    for rank in range(world):
        c = rank_coords(rank, mesh.shape)
        if c[axis]:
            continue
        pencil = _members(c, mesh.shape, (axis,))
        if len({slice_of(r, world, mesh.num_slices) for r in pencil}) > 1:
            return True
    return False


def check_slice_nodes(nodes: Sequence[int], num_slices: int) -> None:
    """Raise ``ValueError`` naming the first slice whose ranks lie on two
    nodes: ``nodes[r]``, rank r's node; the slices slice-major over the
    ranks."""
    world = len(nodes)
    for s in range(num_slices):
        members = [r for r in range(world)
                   if slice_of(r, world, num_slices) == s]
        on = sorted({nodes[r] for r in members})
        if len(on) > 1:
            raise ValueError(
                f"slice {s} of {num_slices} (ranks {members}) spans nodes "
                f"{on}: a slice must lie on one node")


def _gather_nodes(world: int) -> Optional[List[int]]:
    """Every rank's node (``GraftEnv.NODE_RANK``, which the elastic agent
    sets), gathered over the world; None where the workers do not know
    theirs."""
    node = os.environ.get(GraftEnv.NODE_RANK)
    if node is None:
        return None
    nodes: List[int] = [0] * world
    dist.all_gather_object(nodes, int(node))
    return nodes


def build_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh over the ``torch.distributed`` world (one process, no
    group: a world of 1). Every rank calls it, in the same order as its
    other group-forming calls: sp above 1 forms all its groups, and fsdp
    or tp above 1 the groups of every combination of dp, fsdp, sp and
    tp.
    With ``num_slices`` above 1, dp must divide over the slices
    (``ValueError``, as in JAX) and, where the node ranks are known, no
    slice may span two nodes."""
    config = config or MeshConfig()
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    check_ported({a: getattr(config, a) for a in MESH_AXES})
    sizes = config.resolved_sizes(world)
    check_ported(sizes)
    check_slices(sizes, config.num_slices)
    if initialized and config.num_slices > 1:
        nodes = _gather_nodes(world)
        if nodes is not None:
            check_slice_nodes(nodes, config.num_slices)
    keys = []
    if sizes["sp"] > 1:
        keys.append(("sp",))
    if sizes["fsdp"] > 1 or sizes["tp"] > 1:
        for n in range(1, len(GROUP_AXES) + 1):
            for axes in itertools.combinations(GROUP_AXES, n):
                key = _key(sizes, axes)
                if key and key not in keys:
                    keys.append(key)
    groups = {}
    for key in keys:
        for members in axis_groups(sizes, key):
            g = dist.new_group(members)
            if rank in members:
                groups[key] = g
    return Mesh(sizes, rank, groups, config.num_slices)
