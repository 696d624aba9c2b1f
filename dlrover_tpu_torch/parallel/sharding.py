"""ZeRO update sharding: the flat bucket layout and its gradient exchange.

Port of the update-sharding half of ``dlrover_tpu/parallel/sharding.py``
(``CommConfig``, ``PackPlan``, ``build_pack_plan``, ``pack_flat``,
``unpack_flat``, ``exchange_buckets``) for a pure data-parallel world.

The flat stream is the JAX param tree's canonical leaf order (sorted
keys, ``models.convert.param_table``), each leaf in the JAX layout
(layers stacked on axis 0, matrices ``[in, out]``), zero-padded to
``n_buckets × bucket_elems``; so ``pack_flat`` of the port's parameters
is, element for element, the JAX ``pack_flat`` of the converted tree.
Rank ``r`` of a dp group of ``dp`` owns columns ``[r·S, (r+1)·S)`` of
every bucket, ``S = bucket_elems / dp`` (the JAX ``P(None, "dp")``
sharding): its AdamW moments live there, and the gradient exchange is
one ``reduce_scatter_tensor`` a bucket row.

The f32 wire only: ``wire_dtype`` bf16/int8 and ``wire_dtype_dcn``
raise, naming ROADMAP A9 (the int8 wire of ``ops/quant.py`` comes
with them). Tied embeddings need no split-off head cotangent here:
autograd already sums the head's and the lookup's gradients into the
table's, which the plan still places at offset 0 (``tie_size``,
``n_tie_buckets`` as the JAX plan's).
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from dlrover_tpu_torch.models.convert import param_table
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.ops.quant import BLOCK
from dlrover_tpu_torch.parallel.collectives import _host, _staged

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
    each one collective."""

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
        for name in ("wire_dtype", "wire_dtype_dcn"):
            value = getattr(self, name)
            if value is not None and value not in _WIRE_DTYPES:
                raise ValueError(f"{name} must be one of {_WIRE_DTYPES}, "
                                 f"got {value!r}")
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be > 0, got {self.bucket_mb}")
        if self.wire_dtype != "float32" or self.wire_dtype_dcn is not None:
            raise NotImplementedError(
                f"wire_dtype={self.wire_dtype!r}, wire_dtype_dcn="
                f"{self.wire_dtype_dcn!r}: only the float32 wire is ported; "
                "the bf16 and int8 wires are not ported yet (ROADMAP A9)")

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

    def columns(self, rank: int) -> slice:
        """Rank ``rank``'s columns of every bucket."""
        s = self.bucket_elems // self.dp
        return slice(rank * s, (rank + 1) * s)


def pack_rows(cfg: ModelConfig):
    """``param_table`` rows in the JAX canonical (sorted-key) order."""
    return sorted(param_table(cfg), key=lambda row: row[0].split("/"))


def _leaf_shape(cfg: ModelConfig, row, tensors) -> Tuple[int, ...]:
    _, name, stacked, transposed = row
    t = tensors[name.format(0) if stacked else name]
    inner = tuple(t.shape[::-1] if transposed else t.shape)
    return ((cfg.n_layer,) + inner) if stacked else inner


def build_pack_plan(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                    dp: int, bucket_bytes: int = 4 * 2**20,
                    mesh_axes: Tuple[str, ...] = ("dp",)) -> PackPlan:
    """Lay the parameters (a ``Decoder``'s ``named_parameters``) out in
    fixed-size comm buckets, as the JAX ``build_pack_plan`` lays out the
    converted tree: ``bucket_elems`` a multiple of ``dp × quant.BLOCK``,
    the tied table at offset 0."""
    bad = sorted({str(p.dtype) for p in params.values()
                  if p.dtype != torch.float32})
    if bad:
        raise ValueError(
            "update sharding packs a uniform f32 master-param stream; "
            f"found non-f32 leaves: {bad}")
    shapes, sizes, offsets, off = [], [], [], 0
    for row in pack_rows(cfg):
        shape = _leaf_shape(cfg, row, params)
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


def _views(cfg: ModelConfig, tensors, plan: PackPlan, stream: torch.Tensor):
    """(port tensor, its window of ``stream`` in the JAX layout) pairs."""
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
            yield tensors[nm], (w.t() if transposed else w)


@torch.no_grad()
def pack_flat(cfg: ModelConfig, tensors: Dict[str, torch.Tensor],
              plan: PackPlan) -> torch.Tensor:
    """Params (or gradients, by param name) → the ``[n_buckets,
    bucket_elems]`` f32 stream, zero-padded."""
    any_t = next(iter(tensors.values()))
    flat = torch.zeros(plan.padded, dtype=torch.float32, device=any_t.device)
    for t, w in _views(cfg, tensors, plan, flat):
        w.copy_(t)
    return flat.view(plan.n_buckets, plan.bucket_elems)


@torch.no_grad()
def unpack_flat(cfg: ModelConfig, flat: torch.Tensor,
                tensors: Dict[str, torch.Tensor], plan: PackPlan) -> None:
    """Inverse of ``pack_flat``: write the stream into ``tensors`` (by
    param name), in place."""
    for t, w in _views(cfg, tensors, plan, flat.reshape(-1)):
        t.copy_(w)


def exchange_buckets(g: torch.Tensor, plan: PackPlan,
                     group=None) -> torch.Tensor:
    """Reduce-scatter the packed local gradients ``[n_buckets,
    bucket_elems]`` bucket by bucket (from the last bucket down, as the
    JAX exchange issues them); returns this rank's ``[n_buckets,
    bucket_elems / dp]`` of the summed stream. A gloo group meeting a
    CUDA stream runs on one page-locked host copy of it."""
    s = plan.bucket_elems // plan.dp
    staged = _staged(group, g)
    src = _host(g) if staged else g.contiguous()
    out = torch.empty((plan.n_buckets, s), dtype=torch.float32,
                      device=src.device, pin_memory=staged)
    for i in range(plan.n_buckets - 1, -1, -1):
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
                            comm: Optional[CommConfig], mesh_shape=None
                            ) -> Tuple[bool, Optional[str],
                                       Optional[PackPlan]]:
    """(active, fallback_reason, pack_plan) for a requested CommConfig,
    as the JAX ``resolve_update_sharding`` on a pure-dp world: update
    sharding is an optimization, so an unsupported case (dp ≤ 1, a mesh
    axis other than dp above 1, non-f32 params) falls back to the
    replicated update with its reason."""
    if comm is None or not comm.update_sharding:
        return False, None, None
    others = sorted(a for a, n in (mesh_shape or {}).items()
                    if a != "dp" and n > 1)
    if dp <= 1:
        return False, "mesh has dp<=1", None
    if others:
        return False, f"non-dp mesh axes in use: {others}", None
    try:
        return True, None, build_pack_plan(cfg, params, dp,
                                           comm.bucket_bytes)
    except ValueError as e:
        return False, str(e), None

