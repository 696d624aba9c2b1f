"""Logical-axis sharding rules, and ZeRO update sharding's flat bucket
layout and gradient exchange.

Port of ``dlrover_tpu/parallel/sharding.py``: the t5x-style rules
(``DEFAULT_RULES``, ``rules_for_mesh``, ``logical_to_mesh_axes``,
``shardings_for_tree``), which map each parameter's logical axes to mesh
axes (a ``PartitionSpec`` here is a tuple, one entry a dim: None, an
axis, or a tuple of axes), with ``shard_index``, the global index of the
shard a mesh coordinate holds (JAX ``NamedSharding.devices_indices_map``
for an even split); and the update-sharding half (``CommConfig``,
``PackPlan``, ``build_pack_plan``, ``pack_flat``, ``unpack_flat``,
``exchange_buckets``) for a data-parallel world, or the dp axis of a dp ×
fsdp × tp mesh.

The flat stream is the JAX param tree's canonical leaf order (sorted
keys, ``models.convert.param_table``), each leaf whole and in the JAX
layout (layers stacked on axis 0, matrices ``[in, out]``), zero-padded
to ``n_buckets × bucket_elems``; so ``pack_flat`` of the port's
parameters is, element for element, the JAX ``pack_flat`` of the
converted tree. The plan is built on the GLOBAL leaf shapes
(``decoder.param_layout``), with ``mesh_axes`` ``("dp",)`` and the
other axes in use, as the JAX plan is: on a dp × fsdp × tp mesh a rank
holds shards, and ``pack_shards`` lays every fsdp × tp peer's shards
into the one global stream (``unpack_shard`` takes a rank's back out).
Rank ``r`` of a dp group of ``dp`` owns columns ``[r·S, (r+1)·S)`` of
every bucket, ``S = bucket_elems / dp`` (the JAX ``P(None, "dp")``
sharding), the same columns on every fsdp × tp peer: its AdamW moments
live there.

The gradient exchange (``exchange_buckets``, one collective a bucket)
runs on the wire ``CommConfig.wire_for`` names, as JAX
``_exchange_bucket`` does: f32, one ``reduce_scatter_tensor``; bf16,
an all-to-all of the bucket's dp rows as bf16, summed in f32; int8, the
rows encoded (``ops/quant.py`` ``wire_encode_rows``: a scale a
``BLOCK``), an all-to-all of the payloads and of the scales, then
``wire_decode_sum``. ``wire_dtype_dcn`` overrides the wire where dp
crosses slices (``mesh.axis_crosses_dcn``). ``WIRE`` counts the bytes a
rank sends to the others, at the collectives; ``wire_bytes`` is the
plan's count of them. Tied embeddings need no split-off head
cotangent in the step: autograd already sums the head's and the
lookup's gradients into the table's, which the plan still places at
offset 0 (``tie_size``, ``n_tie_buckets`` as the JAX plan's);
``exchange_buckets`` takes a ``tie_extra`` all the same, as JAX's does.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.ops.quant import (
    BLOCK,
    wire_decode_sum,
    wire_encode_rows,
)
from dlrover_tpu_torch.parallel.collectives import (
    _host,
    _staged,
    all_to_all_rows,
)
from dlrover_tpu_torch.parallel.mesh import axis_crosses_dcn

MeshAxes = Union[None, str, Tuple[str, ...]]
# rules: logical axis name -> mesh axis (or tuple, or None)
Rules = Dict[str, MeshAxes]
Spec = Tuple[MeshAxes, ...]

# The default "3D + sequence" ruleset, the JAX package's:
#  - batch over (dp, fsdp): standard fsdp data sharding
#  - seq over sp: sequence/context parallelism
#  - embed over fsdp: ZeRO-3 parameter sharding along the model dim
#  - heads/mlp/vocab over tp: Megatron-style tensor parallelism
#  - experts over ep; layers (scan axis) over pp when pipelining
DEFAULT_RULES: Rules = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "vocab": "tp",
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "expert": "ep",
    "layers": None,
    "norm": None,
}


def rules_for_mesh(mesh_shape: Dict[str, int],
                   rules: Optional[Rules] = None) -> Rules:
    """DEFAULT_RULES specialised to a mesh (its ``shape``): the stacked
    layer axis shards over pp when the mesh pipelines."""
    out = dict(DEFAULT_RULES)
    if mesh_shape.get("pp", 1) > 1:
        out["layers"] = "pp"
    out.update(rules or {})
    return out


def logical_to_mesh_axes(logical_axes: Optional[Sequence[Optional[str]]],
                         rules: Rules) -> Spec:
    """Map a tuple of logical axis names to a partition spec (trailing
    None entries dropped, as ``PartitionSpec`` prints). One mesh axis
    shards at most one tensor dim: a later dim that names a used axis
    stays whole."""
    if logical_axes is None:
        return ()
    spec: List[MeshAxes] = []
    used: set = set()
    for name in logical_axes:
        axis = rules.get(name) if name is not None else None
        if axis is not None:
            axes = axis if isinstance(axis, tuple) else (axis,)
            if any(a in used for a in axes):
                axis = None
            else:
                used.update(axes)
        spec.append(axis)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def shardings_for_tree(mesh_shape: Dict[str, int], logical_tree,
                       rules: Optional[Rules] = None):
    """A tree of logical-axes tuples (``decoder.logical_axes``) → the same
    tree of partition specs."""
    rules = rules_for_mesh(mesh_shape, rules)
    if isinstance(logical_tree, dict):
        return {k: shardings_for_tree(mesh_shape, v, rules)
                for k, v in logical_tree.items()}
    return logical_to_mesh_axes(logical_tree, rules)


def spec_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


#: why an uneven leaf split raises: the JAX package refuses it too
UNEVEN_LEAF = ("the JAX package refuses such a leaf as well (jax.device_put "
               "of an unevenly-sharded leaf fails: \"unevenly-sharded leaves "
               "cannot exist in this framework\", tests/test_checkpoint.py:"
               "119)")


def shard_index(spec: Spec, shape: Sequence[int], mesh_shape: Dict[str, int],
                coords: Dict[str, int]) -> List[List[int]]:
    """The global ``[start, stop]`` a dim of the shard that the device at
    ``coords`` holds of an array of ``shape`` laid out by ``spec``: a dim
    over axes (a, b) is cut in ``size(a)·size(b)`` equal blocks, block
    ``coord(a)·size(b) + coord(b)``. An uneven cut raises ``ValueError``,
    as the JAX placement does (``UNEVEN_LEAF``)."""
    out = []
    for dim, n in enumerate(shape):
        axes = spec_axes(spec[dim]) if dim < len(spec) else ()
        parts, block = 1, 0
        for a in axes:
            parts *= mesh_shape.get(a, 1)
            block = block * mesh_shape.get(a, 1) + coords.get(a, 0)
        if n % parts:
            raise ValueError(
                f"a dim of {n} over mesh axes {axes} ({parts} ways) does not "
                "split evenly: " + UNEVEN_LEAF)
        size = n // parts
        out.append([block * size, (block + 1) * size])
    return out


_WIRE_DTYPES = ("float32", "bfloat16", "int8")
# legacy boolean True maps to "zero2" (the per-micro-batch exchange)
_UPDATE_MODES = ("zero1", "zero2")


@dataclass(frozen=True)
class CommConfig:
    """How gradients cross the dp group and where the optimizer runs.

    ``update_sharding``: False, True (= ``"zero2"``), ``"zero1"`` or
    ``"zero2"``. zero2 reduce-scatters every micro-batch's gradients and
    accumulates this rank's shard; zero1 accumulates the full local
    gradient and exchanges once a step. ``bucket_mb`` sizes the buckets,
    each one collective. ``wire_dtype`` encodes the dp exchange
    ("float32", "bfloat16" or "int8"); ``wire_dtype_dcn`` overrides it
    where dp crosses slices."""

    update_sharding: Union[bool, str] = False
    bucket_mb: float = 4.0
    wire_dtype: str = "float32"
    wire_dtype_dcn: Optional[str] = None

    def __post_init__(self):
        if (
            not isinstance(self.update_sharding, bool)
            and self.update_sharding not in _UPDATE_MODES
        ):
            raise ValueError(
                f"update_sharding must be a bool or one of {_UPDATE_MODES},"
                f" got {self.update_sharding!r}"
            )
        for name, allowed in (("wire_dtype", _WIRE_DTYPES),
                              ("wire_dtype_dcn", _WIRE_DTYPES + (None,))):
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, "
                                 f"got {value!r}")
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")

    @property
    def bucket_bytes(self) -> int:
        return int(self.bucket_mb * 2**20)

    @property
    def update_mode(self) -> str:
        """Resolved mode string: "" (off), "zero1", or "zero2"."""
        if self.update_sharding is False:
            return ""
        if self.update_sharding is True:
            return "zero2"
        return self.update_sharding

    def wire_for(self, mesh=None, axis: str = "dp") -> str:
        """The wire of the gradient exchange over ``axis`` of ``mesh`` (a
        ``parallel.mesh.Mesh``; None: one slice)."""
        if (self.wire_dtype_dcn is not None and mesh is not None
                and axis_crosses_dcn(mesh, axis)):
            return self.wire_dtype_dcn
        return self.wire_dtype


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class PackPlan:
    """Static layout of the parameter stream in comm buckets: the JAX
    ``PackPlan``, field for field."""

    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    bucket_elems: int
    n_buckets: int
    dp: int
    tie_size: int          # 0 when embeddings are untied
    n_tie_buckets: int
    mesh_axes: Tuple[str, ...] = ("dp",)

    @property
    def padded(self) -> int:
        return self.n_buckets * self.bucket_elems

    @property
    def shard_elems(self) -> int:
        """A dp rank's elements of the flat view (optimizer-state rows)."""
        return self.padded // self.dp

    def columns(self, rank: int) -> slice:
        """Dp rank ``rank``'s columns of every bucket."""
        s = self.bucket_elems // self.dp
        return slice(rank * s, (rank + 1) * s)


def pack_rows(cfg: ModelConfig):
    """``param_table`` rows in the JAX canonical (sorted-key) order."""
    from dlrover_tpu_torch.models.decoder import param_table

    return sorted(param_table(cfg), key=lambda row: row[0].split("/"))


def _leaf_shape(cfg: ModelConfig, row, layout) -> Tuple[int, ...]:
    """The GLOBAL JAX leaf shape of a ``param_table`` row (whatever shard
    a rank's tensor holds)."""
    _, name, stacked, _ = row
    inner = tuple(layout[name.format(0) if stacked else name].shape)
    return ((cfg.n_layer,) + inner) if stacked else inner


def build_pack_plan(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                    dp: int, bucket_bytes: int = 4 * 2**20,
                    mesh_axes: Tuple[str, ...] = ("dp",)) -> PackPlan:
    """Lay the parameters (a ``Decoder``'s ``named_parameters``, whole or
    a rank's shards: the dtypes are read, the shapes are the global
    leaves') out in fixed-size comm buckets, as the JAX
    ``build_pack_plan`` lays out the converted tree: ``bucket_elems`` a
    multiple of ``dp × quant.BLOCK``, the tied table at offset 0."""
    from dlrover_tpu_torch.models.decoder import param_layout

    layout = param_layout(cfg)
    bad = sorted({str(p.dtype) for p in params.values()
                  if p.dtype != torch.float32})
    if bad:
        raise ValueError(
            "update sharding packs a uniform f32 master-param stream; "
            f"found non-f32 leaves: {bad}")
    shapes, sizes, offsets, off = [], [], [], 0
    for row in pack_rows(cfg):
        shape = _leaf_shape(cfg, row, layout)
        size = 1
        for d in shape:
            size *= d
        shapes.append(shape)
        sizes.append(size)
        offsets.append(off)
        off += size
    align = dp * BLOCK
    bucket_elems = _round_up(max(bucket_bytes // 4, align), align)
    n_buckets = max(1, -(-off // bucket_elems))
    tie_size = sizes[0] if cfg.tie_embeddings else 0  # embed/tokens first
    n_tie = -(-tie_size // bucket_elems) if tie_size else 0
    return PackPlan(shapes=tuple(shapes), sizes=tuple(sizes),
                    offsets=tuple(offsets), total=off,
                    bucket_elems=bucket_elems, n_buckets=n_buckets, dp=dp,
                    tie_size=tie_size, n_tie_buckets=n_tie,
                    mesh_axes=tuple(mesh_axes))


def _views(cfg: ModelConfig, plan: PackPlan, stream: torch.Tensor):
    """(port name, its window of ``stream`` in the port's layout) pairs:
    the window of the whole tensor."""
    for row, off, shape in zip(pack_rows(cfg), plan.offsets, plan.shapes):
        _, name, stacked, transposed = row
        names = ([name.format(i) for i in range(cfg.n_layer)] if stacked
                 else [name])
        inner = shape[1:] if stacked else shape
        n = 1
        for d in inner:
            n *= d
        for i, nm in enumerate(names):
            w = stream[off + i * n: off + (i + 1) * n].view(inner)
            yield nm, (w.t() if transposed else w)


@torch.no_grad()
def pack_flat(cfg: ModelConfig, tensors: Dict[str, torch.Tensor],
              plan: PackPlan) -> torch.Tensor:
    """Params (or gradients, by param name) → the ``[n_buckets,
    bucket_elems]`` f32 stream, zero-padded."""
    any_t = next(iter(tensors.values()))
    flat = torch.zeros(plan.padded, dtype=torch.float32, device=any_t.device)
    for name, w in _views(cfg, plan, flat):
        w.copy_(tensors[name])
    return flat.view(plan.n_buckets, plan.bucket_elems)


@torch.no_grad()
def unpack_flat(cfg: ModelConfig, flat: torch.Tensor,
                tensors: Dict[str, torch.Tensor], plan: PackPlan) -> None:
    """Inverse of ``pack_flat``: write the stream into ``tensors`` (by
    param name), in place."""
    for name, w in _views(cfg, plan, flat.reshape(-1)):
        tensors[name].copy_(w)


@torch.no_grad()
def pack_shards(cfg: ModelConfig, peers: Sequence[Dict[str, torch.Tensor]],
                layouts: Sequence[Dict], plan: PackPlan) -> torch.Tensor:
    """The global ``[n_buckets, bucket_elems]`` f32 stream from the shards
    of every peer of an fsdp × tp group: ``peers[i]`` peer i's tensors by
    param name, ``layouts[i]`` its ``decoder.param_layout``. Each shard is
    COPIED to its global index, so a leaf the peers hold alike (one
    replicated over tp) lands once, whatever the number of peers."""
    any_t = next(iter(peers[0].values()))
    flat = torch.zeros(plan.padded, dtype=torch.float32, device=any_t.device)
    for name, w in _views(cfg, plan, flat):
        for tensors, layout in zip(peers, layouts):
            w[layout[name].port_slices].copy_(tensors[name])
    return flat.view(plan.n_buckets, plan.bucket_elems)


@torch.no_grad()
def unpack_shard(cfg: ModelConfig, flat: torch.Tensor,
                 tensors: Dict[str, torch.Tensor], plan: PackPlan,
                 layout: Dict) -> None:
    """Write each tensor's shard (``layout``: its rank's
    ``decoder.param_layout``) of the global stream into ``tensors``, in
    place."""
    for name, w in _views(cfg, plan, flat.reshape(-1)):
        tensors[name].copy_(w[layout[name].port_slices])


#: the bytes this process has sent to the other ranks of its group in
#: ``exchange_buckets``, counted at each collective from the tensors it
#: is given: ``(n−1)/n`` of each, the scales included (a ring
#: reduce-scatter sends as much as an all-to-all of the same rows)
WIRE = {"bytes": 0}


def _sent(t: torch.Tensor, n: int) -> None:
    WIRE["bytes"] += t.numel() * t.element_size() * (n - 1) // n


def wire_bytes(plan: PackPlan, wire: str,
               n_buckets: Optional[int] = None) -> int:
    """The bytes a rank sends in ``exchange_buckets`` of ``n_buckets``
    buckets (the plan's by default) on ``wire``: ``(dp−1)/dp`` of each
    bucket's elements, 4 bytes each on f32, 2 on bf16, 1 on int8 plus a
    4-byte scale a ``BLOCK``."""
    n = plan.n_buckets if n_buckets is None else n_buckets
    elems = n * plan.bucket_elems * (plan.dp - 1) // plan.dp
    if wire == "int8":
        return elems + 4 * (elems // BLOCK)
    return elems * (2 if wire == "bfloat16" else 4)


def _exchange_bucket(row: torch.Tensor, wire: str, dp: int, group
                     ) -> torch.Tensor:
    """One quantized bucket: this rank's partial ``[E]`` → its ``[E/dp]``
    of the sum (the f32 wire runs in ``exchange_buckets``)."""
    rows = row.reshape(dp, -1)  # rows[r]: this rank's partial of r's block
    if wire == "bfloat16":
        half = rows.to(torch.bfloat16)
        _sent(half, dp)
        got = all_to_all_rows(half, group).float()
        out = got[0].clone()
        for i in range(1, dp):
            out += got[i]
        return out
    q, scale = wire_encode_rows(rows)
    _sent(q, dp)
    _sent(scale, dp)
    return wire_decode_sum(all_to_all_rows(q, group),
                           all_to_all_rows(scale, group))


def exchange_buckets(g: torch.Tensor, plan: PackPlan, group=None,
                     wire: str = "float32",
                     tie_extra: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Reduce-scatter the packed local gradients ``[n_buckets,
    bucket_elems]`` bucket by bucket over the dp ``group`` (from the last
    bucket down, as the JAX exchange issues them) on ``wire``; returns
    this rank's ``[n_buckets, bucket_elems / dp]`` of the summed stream.
    ``tie_extra`` (a tied head's split-off table gradient, ``[tie_size]``)
    rides its own ``n_tie_buckets`` rows, added onto the leading shards.
    On the f32 wire a gloo group meeting a CUDA stream runs on one
    page-locked host copy of it; the quantized wires encode on the
    stream's device and stage what they send."""
    if wire not in _WIRE_DTYPES:
        raise ValueError(f"wire must be one of {_WIRE_DTYPES}, got {wire!r}")
    shards = _exchange(g, plan, group, wire)
    if tie_extra is not None and plan.tie_size:
        extra = torch.zeros(plan.n_tie_buckets * plan.bucket_elems,
                            dtype=torch.float32, device=g.device)
        extra[:plan.tie_size] = tie_extra.reshape(-1)
        extra = extra.view(plan.n_tie_buckets, plan.bucket_elems)
        shards[:plan.n_tie_buckets] += _exchange(extra, plan, group, wire)
    return shards


def _exchange(g: torch.Tensor, plan: PackPlan, group, wire: str
              ) -> torch.Tensor:
    n = g.shape[0]
    s = plan.bucket_elems // plan.dp
    if wire != "float32":
        out = torch.empty((n, s), dtype=torch.float32, device=g.device)
        for i in range(n - 1, -1, -1):
            out[i] = _exchange_bucket(g[i].float(), wire, plan.dp, group)
        return out
    staged = _staged(group, g)
    src = _host(g) if staged else g.contiguous()
    out = torch.empty((n, s), dtype=torch.float32,
                      device=src.device, pin_memory=staged)
    for i in range(n - 1, -1, -1):
        _sent(src[i], plan.dp)
        dist.reduce_scatter_tensor(out[i], src[i], group=group)
    return out.to(g.device) if staged else out


def all_gather_columns(shard: torch.Tensor, plan: PackPlan,
                       group=None) -> torch.Tensor:
    """Every rank's ``[n_buckets, S]`` columns → the whole ``[n_buckets,
    bucket_elems]`` stream (one all-gather)."""
    staged = _staged(group, shard)
    src = _host(shard) if staged else shard.contiguous()
    out = torch.empty(plan.dp * src.numel(), dtype=src.dtype,
                      device=src.device, pin_memory=staged)
    dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    if staged:
        out = out.to(shard.device)
    return out.view((plan.dp,) + tuple(src.shape)).permute(1, 0, 2).reshape(
        plan.n_buckets, plan.bucket_elems)


def resolve_update_sharding(cfg: ModelConfig,
                            params: Dict[str, torch.Tensor], dp: int,
                            comm: Optional[CommConfig], mesh=None
                            ) -> Tuple[bool, Optional[str],
                                       Optional[PackPlan]]:
    """(active, fallback_reason, pack_plan) for a requested CommConfig,
    as the JAX ``resolve_update_sharding``: update sharding is an
    optimization, so an unsupported case falls back to the replicated
    update with the JAX reason: dp ≤ 1; a mesh axis above 1 other than
    dp, fsdp and tp; a quantized wire on a mesh with fsdp or tp in use;
    non-f32 params. ``mesh``: a ``parallel.mesh.Mesh``, whose dp is the
    plan's; without one, ``dp`` (a data-parallel group's size). MoE, fp8
    and a custom loss are refused earlier in the port (ROADMAP A16,
    A17)."""
    if comm is None or not comm.update_sharding:
        return False, None, None
    shape = {} if mesh is None else mesh.shape
    if mesh is not None:
        dp = shape["dp"]
    others = sorted(a for a, n in shape.items() if a != "dp" and n > 1)
    unsupported = [a for a in others if a not in ("fsdp", "tp")]
    reason = None
    if dp <= 1:
        reason = "mesh has dp<=1"
    elif unsupported:
        reason = f"non-dp mesh axes beyond fsdp/tp in use: {unsupported}"
    elif others and comm.wire_for(mesh, "dp") != "float32":
        reason = ("quantized wire dtypes need a pure-dp mesh (all_to_all "
                  "over dp cannot lower inside the partial-manual region)")
    if reason is not None:
        return False, reason, None
    try:
        return True, None, build_pack_plan(
            cfg, params, dp, comm.bucket_bytes,
            mesh_axes=("dp",) + tuple(others))
    except ValueError as e:
        return False, str(e), None
