"""Decoder-only transformer: paged serving and the training forward.

Port of ``dlrover_tpu/models/decoder.py`` as an ``nn.Module``: ``init``
(same parameter names and shapes, matrices in ``nn.Linear``'s
``[out, in]`` layout, drawn from a ``torch.Generator``), ``_norm``,
``_rope_tables``/``_rope``, ``_project_qkv`` and ``_mlp_block`` (no fp8,
no mesh), ``_cache_layer_tail`` (dense, with ``parallel_residual``),
``_paged_guards``, ``decode_step_paged``, ``prefill_chunk_paged`` and
``verify_chunk_paged`` for serving; ``_norm_block``,
``_attention_block``, ``_layer_body``, ``run_trunk``, ``forward``,
``head_weight_scale`` and ``loss_fn`` for training (dense layers; no
fp8, MoE or pipeline). Under a mesh with sp above 1
(``parallel/mesh.py``) each rank runs its rows and its sequence block:
positions are global (``sp rank · S_l + arange(S_l)``) and attention is
``ring_attention`` or ``ulysses_attention`` (``parallel/sequence.py``),
alone or with fsdp and tp.

Under a mesh with fsdp or tp above 1 (``Decoder(cfg, mesh=...)``) each
parameter holds only this rank's shard, laid out by the JAX rules
(``logical_axes``, ``param_layout``: ``embed`` over fsdp, ``heads``,
``mlp`` and ``vocab`` over tp, ``kv`` whole), the transpose of it where
``nn.Linear`` keeps ``[out, in]``. The forward gathers each weight's
fsdp-cut dim on use (``collectives.fsdp_gather``: the gathered weight is
kept for the backward, which frees it; under ``remat="full"`` the
recompute gathers again), and runs Megatron's tensor parallelism: ``wq``,
``w_gate`` and ``w_up`` column-parallel, ``wo`` and ``w_down``
row-parallel with a sum over tp, a rank's query heads attending to the
KV heads they map to under GQA (rows of the replicated ``wk``/``wv``),
the vocab-parallel embedding lookup (a masked take and a sum over tp)
and the vocab-parallel head and loss (``fused_ce.vocab_parallel_ce``).
JAX counterparts: ``_attention_block``, ``_mlp_block``,
``_vocab_parallel_embed`` and ``loss_fn``'s unfused path under GSPMD.
A rank's ``wq`` columns are always the JAX leaf's column block; where
tp does not divide ``n_head`` the attention runs on whole heads in
GSPMD's padded head blocks (``TpPlan``: the columns moved over tp to
the heads and back), and inside a sequence-parallel attention every tp
rank attends over all heads unless tp divides both head counts (the
JAX ``_head_axis``). The sharded model trains; its paged serving steps
refuse.

For serving (``Decoder(cfg)``), matrices are stored frozen in the
compute dtype (``cfg.dtype``). For training (``Decoder(cfg,
trainable=True)``) every parameter is trainable in ``cfg.param_dtype``.
Either way each matrix is cast to the activations' dtype at its use, as
JAX's ``x @ w.astype(x.dtype)`` does (a no-op for serving's weights), so
the numbers are the same. Norm scales and biases stay f32, as JAX reads
them. Logits are f32: the head runs on the f32 upcast of its bf16
operands, which is what JAX's ``preferred_element_type=f32`` computes.

Training sends every layer norm through ``ops.norm`` (the fused norm
kernels on the card) and attention through ``ops.flash_attention`` (the
flash kernels on the card); on the CPU both run their plain versions.

The paged steps write each new K/V row into its page cell IN PLACE
(``ops.paged_attention.write_page_rows``) and attend through
``ops.paged_attention.paged_attention`` — the hand-written CUDA kernel
on the card, its plain PyTorch version on the CPU. No contiguous
``[L, B, S, ...]`` cache exists anywhere. The verify step writes
nothing: its chunk rows are in-flight keys of the kernel's ``verify``
variant, and the engine commits the accepted ones afterwards.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.ops import norm as fused_norm
from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.ops.attention import mha_reference
from dlrover_tpu_torch.ops.fused_ce import (
    _mm_f32,
    fused_linear_ce,
    vocab_parallel_ce,
)
from dlrover_tpu_torch.ops.flash_attention import flash_attention
from dlrover_tpu_torch.ops.paged_attention import (
    paged_attention,
    write_page_rows,
)
from dlrover_tpu_torch.parallel import sharding as shd
from dlrover_tpu_torch.parallel.collectives import (
    copy_to_tp,
    fsdp_gather,
    gather_from_tp,
    gather_sum_tp,
    reduce_from_tp,
    tp_reshard,
)
from dlrover_tpu_torch.parallel.sequence import _KeepInGraph, head_axis
from dlrover_tpu_torch.serving.kv_cache import layer_pools

Pools = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain functions on tensors
# ---------------------------------------------------------------------------


def _norm(x, scale, bias, kind: str):
    """rmsnorm / layernorm with f32 statistics, output in ``x.dtype``."""
    x32 = x.to(torch.float32)
    if kind == "rmsnorm":
        rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
        out = x32 * rms * scale.to(torch.float32)
    else:
        # single pass over the f32 upcast: E[x] and E[x²]; var clamped
        # at 0 against catastrophic cancellation
        mean = x32.mean(-1, keepdim=True)
        ex2 = (x32 * x32).mean(-1, keepdim=True)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        out = (x32 - mean) * torch.rsqrt(var + 1e-5)
        out = out * scale.to(torch.float32)
        if bias is not None:
            out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin rope tables ``[B, S, 1, D/2]`` f32 from positions
    ``[B, S]`` — built once per step and shared by every layer."""
    freqs = theta ** (
        -torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=positions.device) / head_dim
    )
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x: torch.Tensor, rope) -> torch.Tensor:
    """Rotary embedding, rotate-half: lane i pairs with lane i + D/2
    (not interleaved pairs). ``x`` ``[B, S, H, D]``."""
    d = x.shape[-1]
    cos, sin = rope
    xr = x.to(torch.float32).reshape(*x.shape[:-1], 2, d // 2)
    x1, x2 = xr[..., 0, :], xr[..., 1, :]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-2)
    return out.reshape(x.shape).to(x.dtype)


def _project_qkv(x, layer, cfg: ModelConfig, rope, *,
                 mup_full_scale: bool, tp=None):
    """QKV projection + rope + muP q-scaling. muP wants 1/d_head of
    attention scaling in all: the training attention applies
    1/sqrt(d_head) itself, so q carries the other half; the cache paths
    run attention at scale 1 and set ``mup_full_scale``. ``tp``: this
    rank's ``TpPlan`` (its ``wq`` columns moved to the query heads it
    attends over; its KV heads' rows of ``wk`` and ``wv``)."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    rows = None
    q = _dense(x, layer.attn.wq)
    if tp is not None:
        nh, nkv, rows = tp.heads, tp.kv_heads, tp.kv_rows
        q = tp.q_heads(q)
    q = q.reshape(b, s, nh, hd)
    k = _dense(x, layer.attn.wk, rows).reshape(b, s, nkv, hd)
    v = _dense(x, layer.attn.wv, rows).reshape(b, s, nkv, hd)
    if rope is not None:
        q = _rope(q, rope)
        k = _rope(k, rope)
    if cfg.mup_base_width:
        q = q * (hd ** (-1.0 if mup_full_scale else -0.5))
    return q, k, v


def _paged_guards(cfg: ModelConfig, fn: str, sharded: bool = False):
    if sharded:
        raise NotImplementedError(
            f"{fn} serves whole weights; a model sharded over fsdp or tp "
            "trains only")
    if not cfg.causal:
        raise ValueError(f"{fn} requires a causal model")
    if cfg.prefix_lm:
        raise ValueError(
            f"{fn} is causal-only: paged serving prefills causally in "
            "chunks, which can never build a prefix-LM cache"
        )
    if getattr(cfg, "pp_interleave", 1) > 1:
        raise ValueError(
            f"{fn} runs layers in storage order; interleave-stacked "
            "checkpoints are not served"
        )


# ---------------------------------------------------------------------------
# The parameter table and its layout on a mesh
# ---------------------------------------------------------------------------

_ATTN = ("wq", "wk", "wv", "wo")

# (JAX path, port name, or its per-layer format, stacked, transposed)
ParamRow = Tuple[str, str, bool, bool]


def param_table(cfg: ModelConfig) -> List[ParamRow]:
    """Each param leaf of the JAX tree and the port tensor(s) behind it:
    the JAX tree stacks per-layer tensors on axis 0 and keeps matrices
    ``[in, out]``, the port one ``nn.Linear`` a layer, ``[out, in]``."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE decoders are not ported yet (ROADMAP A16)")
    mlp = ("w_gate", "w_up", "w_down") if cfg.act == "swiglu" else (
        "w_up", "w_down")
    norm = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    rows: List[ParamRow] = [("embed/tokens", "embed.tokens", False, False)]
    if cfg.pos == "learned":
        rows.append(("pos_embed/table", "pos_embed.table", False, False))
    rows += [(f"layers/attn/{n}", f"layers.{{}}.attn.{n}.weight", True, True)
             for n in _ATTN]
    rows += [(f"layers/mlp/{n}", f"layers.{{}}.mlp.{n}.weight", True, True)
             for n in mlp]
    rows += [(f"layers/{ln}/{k}", f"layers.{{}}.{ln}.{k}", True, False)
             for ln in ("ln1", "ln2") for k in norm]
    rows += [(f"final_norm/{k}", f"final_norm.{k}", False, False)
             for k in norm]
    if not cfg.tie_embeddings:
        rows.append(("lm_head/w", "lm_head.weight", False, True))
    return rows


def logical_axes(cfg: ModelConfig) -> Dict:
    """Pytree of logical-axis tuples, the structure of the JAX ``init``'s
    param tree (``dlrover_tpu/models/decoder.py`` ``logical_axes``)."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE decoders are not ported yet (ROADMAP A16)")
    ax: Dict = {
        "embed": {"tokens": ("vocab", "embed")},
        "layers": {
            "attn": {
                "wq": ("layers", "embed", "heads"),
                "wk": ("layers", "embed", "kv"),
                "wv": ("layers", "embed", "kv"),
                "wo": ("layers", "heads", "embed"),
            },
            "ln1": {"scale": ("layers", "norm")},
            "ln2": {"scale": ("layers", "norm")},
        },
        "final_norm": {"scale": ("norm",)},
    }
    mlp = ("w_gate", "w_up") if cfg.act == "swiglu" else ("w_up",)
    ax["layers"]["mlp"] = {n: ("layers", "embed", "mlp") for n in mlp}
    ax["layers"]["mlp"]["w_down"] = ("layers", "mlp", "embed")
    if cfg.norm == "layernorm":
        ax["layers"]["ln1"]["bias"] = ("layers", "norm")
        ax["layers"]["ln2"]["bias"] = ("layers", "norm")
        ax["final_norm"]["bias"] = ("norm",)
    if cfg.pos == "learned":
        ax["pos_embed"] = {"table": ("seq", "embed")}
    if not cfg.tie_embeddings:
        ax["lm_head"] = {"w": ("embed", "vocab")}
    return ax


#: the mesh axes the port cuts parameters over. The JAX rules also put a
#: learned position table's ``seq`` over sp; the port keeps the table
#: whole over sp on every mesh (each sp rank reads the rows of its block
#: from it), so its gradient is summed over sp like every other leaf's
PARAM_CUT_AXES = ("fsdp", "tp")
#: leaves replicated over tp whose use each tp rank splits (the KV heads
#: of its query heads): their gradients are summed over tp
TP_SPLIT_USE = ("layers/attn/wk", "layers/attn/wv")


@dataclass(frozen=True)
class ParamShard:
    """One port tensor's place in its JAX leaf on this rank: the leaf's
    JAX path, the global shape and this rank's ``[start, stop]`` a dim in
    the JAX layout (a stacked leaf's per-layer slice: no layer dim), the
    partition spec (mesh axes a dim) and whether the port holds the
    transpose."""

    path: str
    shape: Tuple[int, ...]
    index: Tuple[Tuple[int, int], ...]
    spec: shd.Spec
    transposed: bool

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes this leaf is cut over."""
        return tuple(a for e in self.spec for a in shd.spec_axes(e))

    def _port(self, seq):
        return tuple(seq[::-1]) if self.transposed else tuple(seq)

    @property
    def port_shape(self) -> Tuple[int, ...]:
        """The local tensor's shape, in the port's layout."""
        return self._port([b - a for a, b in self.index])

    @property
    def port_global_shape(self) -> Tuple[int, ...]:
        return self._port(self.shape)

    @property
    def port_slices(self) -> Tuple[slice, ...]:
        """This shard's slices of the port-layout global tensor."""
        return self._port([slice(a, b) for a, b in self.index])

    @property
    def fsdp_dim(self) -> Optional[int]:
        """The port dim cut over fsdp, or None."""
        for d, e in enumerate(self.spec):
            if "fsdp" in shd.spec_axes(e):
                return len(self.shape) - 1 - d if self.transposed else d
        return None


def check_mesh(cfg: ModelConfig, mesh_shape: Dict[str, int]) -> None:
    """Raise ``ValueError`` for a leaf dim its mesh axes do not divide: a
    tp that does not divide the q columns (``n_head · head_dim``), ``d_ff``
    or ``vocab_size``, or an fsdp that does not divide ``d_model``, as the
    JAX placement does. A tp that does not divide ``n_head`` itself runs
    (``TpPlan``: GSPMD's padded head blocks)."""
    tp, fsdp = mesh_shape.get("tp", 1), mesh_shape.get("fsdp", 1)
    bad = [f"{name}={n} over tp={tp}" for name, n in (
        ("n_head*head_dim", cfg.n_head * cfg.head_dim), ("d_ff", cfg.d_ff),
        ("vocab_size", cfg.vocab_size)) if n % tp]
    if cfg.d_model % fsdp:
        bad.append(f"d_model={cfg.d_model} over fsdp={fsdp}")
    if bad:
        raise ValueError(f"{', '.join(bad)} does not split evenly: "
                         + shd.UNEVEN_LEAF)


def param_layout(cfg: ModelConfig, mesh=None) -> Dict[str, ParamShard]:
    """Every port parameter's ``ParamShard`` on ``mesh``'s rank (by port
    name): the JAX ``shardings_for_tree(mesh, logical_axes(cfg))`` spec
    of its leaf, cut to the axes the port shards parameters over, and
    the index ``NamedSharding.devices_indices_map`` gives that rank.
    Without a mesh every shard is its whole leaf."""
    shape = {} if mesh is None else dict(mesh.shape)
    coords = {} if mesh is None else dict(mesh.coords)
    if mesh is not None:
        check_mesh(cfg, shape)
    specs = shd.shardings_for_tree(shape, logical_axes(cfg))
    out = {}
    for path, name, stacked, transposed in param_table(cfg):
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        jax_shape = _leaf_shape(cfg, path)
        spec = tuple(_cut(e) for e in (spec[1:] if stacked else spec))
        index = shd.shard_index(spec, jax_shape, shape, coords)
        shard = ParamShard(path, jax_shape, tuple(map(tuple, index)), spec,
                           transposed)
        for i in range(cfg.n_layer) if stacked else (None,):
            out[name.format(i) if stacked else name] = shard
    return out


def _cut(entry: shd.MeshAxes) -> shd.MeshAxes:
    """A spec entry kept to ``PARAM_CUT_AXES``."""
    axes = tuple(a for a in shd.spec_axes(entry) if a in PARAM_CUT_AXES)
    return axes[0] if len(axes) == 1 else (axes or None)


def _leaf_shape(cfg: ModelConfig, path: str) -> Tuple[int, ...]:
    """The JAX leaf's shape (a stacked leaf's per-layer shape)."""
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    q, kv = cfg.n_head * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    last = path.split("/")[-1]
    return {"embed/tokens": (v, d), "pos_embed/table": (cfg.max_seq, d),
            "layers/attn/wq": (d, q), "layers/attn/wk": (d, kv),
            "layers/attn/wv": (d, kv), "layers/attn/wo": (q, d),
            "layers/mlp/w_gate": (d, f), "layers/mlp/w_up": (d, f),
            "layers/mlp/w_down": (f, d), "lm_head/w": (d, v),
            }.get(path, (d,) if last in ("scale", "bias") else None)


@dataclass(frozen=True)
class TpPlan:
    """This rank's share of the heads and the vocab under tp. Its ``wq``
    columns are block ``rank`` of ``cols`` (the JAX leaf's column block,
    ``n_head · head_dim / tp`` wide), its ``wo`` rows the same. ``mode``
    says which query heads it attends over:

    - ``"even"``: tp divides ``n_head``; its columns are its heads;
    - ``"heads"``: tp does not divide ``n_head`` (no sp): the whole heads
      of its block of ``head_cols``, GSPMD's padded head blocks
      (``ceil(n_head / tp)`` heads a rank, the last ranks fewer, maybe
      none); the q columns are moved there over tp before attention and
      the output back after (``collectives.tp_reshard``);
    - ``"all"``: under sp, where tp does not divide both head counts
      (``sequence.head_axis`` is None, the JAX ``_head_axis``): every
      head, its q columns gathered over tp, and it keeps its columns of
      the output.

    ``heads``: how many; ``kv_rows``: the rows of ``wk``/``wv`` (port
    layout) of the KV heads they map to under GQA (a slice, a LongTensor
    when the heads cover KV groups unevenly: each query head its own KV
    head's rows, ``kv_heads == heads``; None: all), ``kv_heads`` how many
    those are; its vocab block ``[vocab_start, vocab_start +
    vocab_size)``."""

    mesh: object
    rank: int
    mode: str
    heads: int
    kv_rows: object
    kv_heads: int
    cols: Tuple[Tuple[int, int], ...]
    head_cols: Tuple[Tuple[int, int], ...]
    vocab_start: int
    vocab_size: int

    def q_heads(self, q: torch.Tensor) -> torch.Tensor:
        """``q`` ``[..., cols]`` from this rank's ``wq`` columns → the
        columns of the heads it attends over."""
        if self.mode == "heads":
            return tp_reshard(q, self.cols, self.head_cols, self.mesh)
        if self.mode == "all":
            return gather_sum_tp(q, -1, self.mesh)
        return q

    def out_cols(self, out: torch.Tensor) -> torch.Tensor:
        """The attention output of its heads ``[..., heads · head_dim]`` →
        the columns of its ``wo`` rows."""
        if self.mode == "heads":
            return tp_reshard(out, self.head_cols, self.cols, self.mesh)
        if self.mode == "all":
            lo, hi = self.cols[self.rank]
            return out[..., lo:hi]
        return out


def _kv_rows(first: int, n: int, rep: int, hd: int, device):
    """(rows of ``wk``/``wv``, KV head count) of query heads ``[first,
    first + n)`` under GQA with ``rep`` query heads a KV head."""
    if n == 0:
        return slice(0, 0), 0
    lo, last = first // rep, (first + n - 1) // rep
    if lo == last:
        return slice(lo * hd, (lo + 1) * hd), 1
    if first % rep == 0 and n % rep == 0:
        return slice(lo * hd, (last + 1) * hd), n // rep
    heads = (first + torch.arange(n)) // rep
    rows = (heads[:, None] * hd + torch.arange(hd)).reshape(-1).to(device)
    return rows, n


def tp_plan(cfg: ModelConfig, mesh, device) -> Optional[TpPlan]:
    """The ``TpPlan`` of ``mesh``'s rank, or None when tp is 1."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    if tp == 1:
        return None
    r, hd, nh = mesh.coord("tp"), cfg.head_dim, cfg.n_head
    width = nh * hd // tp
    cols = tuple((i * width, (i + 1) * width) for i in range(tp))
    h = -(-nh // tp)
    head_cols = tuple((min(i * h, nh) * hd, min((i + 1) * h, nh) * hd)
                      for i in range(tp))
    vl = cfg.vocab_size // tp
    if mesh.shape["sp"] > 1 and head_axis(mesh.shape, nh,
                                          cfg.kv_heads) is None:
        return TpPlan(mesh, r, "all", nh, None, cfg.kv_heads, cols,
                      head_cols, r * vl, vl)
    first = head_cols[r][0] // hd
    n = head_cols[r][1] // hd - first
    rows, kv = _kv_rows(first, n, nh // cfg.kv_heads, hd, device)
    return TpPlan(mesh, r, "even" if nh % tp == 0 else "heads", n, rows, kv,
                  cols, head_cols, r * vl, vl)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _use(p: torch.Tensor, module: nn.Module, dtype) -> torch.Tensor:
    """Parameter ``p`` of ``module`` in ``dtype``, its fsdp-cut dim
    gathered when the module's ``fsdp`` says so (``(dim, mesh)``)."""
    cut = getattr(module, "fsdp", None)
    if cut is None:
        return p.to(dtype)
    return fsdp_gather(p, cut[0], dtype, cut[1])


def _dense(x: torch.Tensor, lin: nn.Linear, rows=None) -> torch.Tensor:
    """``x @ w.astype(x.dtype)``: the weight cast to the activations'
    dtype at its use (a no-op for serving's compute-dtype weights),
    gathered over fsdp under a sharded layout; ``rows``: only those rows
    of the port-layout weight (output features)."""
    w = _use(lin.weight, lin, x.dtype)
    if rows is not None:
        w = w[rows]
    return F.linear(x, w)


class Norm(nn.Module):
    """Norm parameters (f32 ``scale``, plus ``bias`` for layernorm)."""

    def __init__(self, d: int, kind: str, device):
        super().__init__()
        self.kind = kind
        self.scale = _frozen(torch.ones(d, dtype=torch.float32, device=device))
        self.bias = (
            _frozen(torch.zeros(d, dtype=torch.float32, device=device))
            if kind == "layernorm" else None
        )

    def forward(self, x):
        return _norm(x, self.scale, self.bias, self.kind)


class Table(nn.Module):
    """A bare parameter table (``embed.tokens``, ``pos_embed.table``)."""

    def __init__(self, name: str, shape, dtype, device):
        super().__init__()
        self.register_parameter(
            name, _frozen(torch.empty(shape, dtype=dtype, device=device))
        )


def _linear(shape, dtype, device) -> nn.Linear:
    """An ``nn.Linear`` whose weight is ``shape`` (``[out, in]``)."""
    lin = nn.Linear(shape[1], shape[0], bias=False, dtype=dtype,
                    device=device)
    lin.weight.requires_grad_(False)
    return lin


class Attention(nn.Module):
    def __init__(self, shape, dtype, device):
        super().__init__()
        for n in _ATTN:
            setattr(self, n, _linear(shape(f"attn.{n}.weight"), dtype,
                                     device))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, shape, dtype, device):
        super().__init__()
        self.act = cfg.act
        if cfg.act == "swiglu":
            self.w_gate = _linear(shape("mlp.w_gate.weight"), dtype, device)
        self.w_up = _linear(shape("mlp.w_up.weight"), dtype, device)
        self.w_down = _linear(shape("mlp.w_down.weight"), dtype, device)

    def forward(self, x, tp: Optional[TpPlan] = None):
        """``_mlp_block``: swiglu ``silu(x·Wg) * (x·Wu)`` or tanh-gelu;
        under tp ``w_gate``/``w_up`` column-parallel, ``w_down``
        row-parallel and summed over tp."""
        if tp is not None:
            x = copy_to_tp(x, tp.mesh)
        if self.act == "swiglu":
            h = F.silu(_dense(x, self.w_gate)) * _dense(x, self.w_up)
        else:
            h = F.gelu(_dense(x, self.w_up), approximate="tanh")
        out = _dense(h, self.w_down)
        return out if tp is None else reduce_from_tp(out, tp.mesh)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, shape, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = Attention(shape, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg, shape, dtype, device)


class Decoder(nn.Module):
    """The decoder's parameters, its paged serving steps, and (through
    the module functions ``forward``/``loss_fn``) its training forward.

    ``Decoder(cfg)`` allocates on ``device`` (default ``"cuda"``; raises
    without a card) with uninitialized weights: fill them with
    ``init_weights`` or ``models.convert.load_jax_params``. Serving
    weights are frozen in ``cfg.dtype``; ``trainable=True`` keeps every
    parameter trainable in ``cfg.param_dtype`` instead. ``mesh``: a
    ``parallel.mesh.Mesh`` with fsdp or tp above 1 makes every parameter
    this rank's shard (``layout``, by parameter name); any other mesh,
    or None, keeps them whole."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 trainable: bool = False, mesh=None):
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "MoE decoders are not ported yet (ROADMAP A16)"
            )
        dev = resolve_device(device)
        dt = getattr(torch, cfg.param_dtype if trainable else cfg.dtype)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.sharded else None
        self.layout = param_layout(cfg, self.mesh)

        def shape(name):
            return self.layout[name].port_shape

        self.embed = Table("tokens", shape("embed.tokens"), dt, dev)
        if cfg.pos == "learned":
            self.pos_embed = Table("table", shape("pos_embed.table"), dt,
                                   dev)
        self.layers = nn.ModuleList(
            Layer(cfg, lambda n: shape(f"layers.0.{n}"), dt, dev)
            for _ in range(cfg.n_layer)
        )
        self.final_norm = Norm(cfg.d_model, cfg.norm, dev)
        self.lm_head = (None if cfg.tie_embeddings
                        else _linear(shape("lm_head.weight"), dt, dev))
        self.requires_grad_(trainable)
        self.tp = tp_plan(cfg, self.mesh, dev)
        if self.mesh is not None and self.mesh.shape["fsdp"] > 1:
            for name, mod in self.named_modules():
                for pname, _ in mod.named_parameters(recurse=False):
                    dim = self.layout[f"{name}.{pname}"].fsdp_dim
                    if dim is not None:
                        mod.fsdp = (dim, self.mesh)

    @property
    def device(self) -> torch.device:
        return self.embed.tokens.device

    # ---- init --------------------------------------------------------------

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Decoder":
        """Draw every matrix as N(0, 1) / sqrt(fan_in) (the embedding
        N(0, 0.02²), learned positions N(0, 0.01²)) from ``generator``,
        whose device must be the model's; norms to 1/0 — the scales of
        the JAX ``init``, not its bits. Each matrix is drawn whole, one at
        a time, and a sharded model keeps its shard: every layout holds
        the same global weights."""
        dev = self.device

        def draw(name: str, p: torch.Tensor, std: float):
            shard = self.layout[name]
            x = torch.randn(shard.port_global_shape, generator=generator,
                            device=dev, dtype=torch.float32)
            p.copy_(x[shard.port_slices].mul_(std))

        draw("embed.tokens", self.embed.tokens, 0.02)
        if self.cfg.pos == "learned":
            draw("pos_embed.table", self.pos_embed.table, 0.01)
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                fan_in = self.layout[name + ".weight"].shape[0]
                draw(name + ".weight", mod.weight, 1.0 / math.sqrt(fan_in))
            elif isinstance(mod, Norm):
                mod.scale.fill_(1.0)
                if mod.bias is not None:
                    mod.bias.zero_()
        return self

    # ---- pieces ------------------------------------------------------------

    def _embed(self, tokens, positions):
        """Token (and learned position) rows, cast to ``cfg.dtype``.
        Sharded, the tables are gathered over fsdp in their own dtype (the
        lookup's gradient accumulates in f32, as one process's) and the
        token rows come from the vocab-parallel lookup under tp."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        table = _use(self.embed.tokens, self.embed, self.embed.tokens.dtype)
        if self.tp is None:
            x = table[tokens.long()].to(dt)
        else:
            # _vocab_parallel_embed: out-of-block ids take row 0, masked
            idx = tokens.long() - self.tp.vocab_start
            inb = (idx >= 0) & (idx < self.tp.vocab_size)
            x = table[torch.where(inb, idx, 0)].to(dt)
            x = reduce_from_tp(torch.where(inb[..., None], x, 0),
                               self.tp.mesh)
        if cfg.pos == "learned":
            pos = _use(self.pos_embed.table, self.pos_embed,
                       self.pos_embed.table.dtype)
            x = x + pos[positions.long()].to(dt)
        return x

    def _cache_layer_tail(self, x, attn_out, layer: Layer):
        """Residual + MLP wiring shared by prefill and decode."""
        if self.cfg.parallel_residual:
            h2 = layer.ln2(x)
        else:
            x = x + attn_out
            h2 = layer.ln2(x)
        mlp_out = layer.mlp(h2)
        if self.cfg.parallel_residual:
            return x + attn_out + mlp_out
        return x + mlp_out

    def _logits(self, x):
        """f32 logits ``[..., V]`` from the final-normed stream."""
        cfg = self.cfg
        x = self.final_norm(x)
        w = self.embed.tokens if cfg.tie_embeddings else self.lm_head.weight
        logits = F.linear(x.to(torch.float32), w.to(torch.float32))
        if cfg.mup_base_width and cfg.tie_embeddings:
            logits = logits * (cfg.mup_base_width / cfg.d_model)
        return logits

    def _layers(self, x, pools, tables, positions, write_valid, attn_pos,
                variant, max_pages):
        cfg = self.cfg
        b, c, _ = x.shape
        rope = (
            _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos == "rope" else None
        )
        scale = 1.0 if cfg.mup_base_width else cfg.head_dim ** -0.5
        for i, layer in enumerate(self.layers):
            pools_l = layer_pools(pools, i)
            h = layer.ln1(x)
            q, k, v = _project_qkv(h, layer, cfg, rope, mup_full_scale=True)
            # write-before-attend: the new rows are keys of this step
            write_page_rows(pools_l, tables, positions, write_valid, k, v)
            attn = paged_attention(
                q, pools_l, tables, attn_pos, scale=scale,
                window=cfg.attn_window, kv_heads=cfg.kv_heads,
                max_pages=max_pages, variant=variant,
            ).reshape(b, c, cfg.n_head * cfg.head_dim)
            x = self._cache_layer_tail(x, _dense(attn, layer.attn.wo), layer)
        return x

    # ---- paged steps -------------------------------------------------------

    @torch.no_grad()
    def decode_step_paged(
        self,
        tokens: torch.Tensor,        # [B] int — token at position ``pos``
        pools: Pools,                # layer-leading page pools, updated in place
        block_tables: torch.Tensor,  # [B, max_pages] int32, -1 = unassigned
        pos: torch.Tensor,           # [B] int per-slot positions
        valid: torch.Tensor,         # [B] bool — invalid lanes write trash
        *,
        max_pages: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Pools]:
        """One token for every slot over the paged pools: each layer
        commits the new K/V row to its page cell (encode-on-write in
        int8 mode) and attends with the paged kernel, whose walk
        ``max_pages`` bounds. Returns (logits ``[B, V]`` f32, pools)."""
        _paged_guards(self.cfg, "decode_step_paged", self.mesh is not None)
        if pos.ndim != 1:
            raise ValueError("decode_step_paged is per-slot: pos must be [B]")
        positions = pos[:, None].to(torch.int32)
        tables = block_tables.to(torch.int32)
        x = self._embed(tokens[:, None], positions)
        x = self._layers(x, pools, tables, positions, valid[:, None], pos,
                         "decode", max_pages)
        return self._logits(x)[:, 0], pools

    @torch.no_grad()
    def prefill_chunk_paged(
        self,
        tokens: torch.Tensor,        # [B, C] int — one prompt chunk per slot
        pools: Pools,                # layer-leading page pools, updated in place
        block_tables: torch.Tensor,  # [B, max_pages] int32
        start: torch.Tensor,         # [B] int chunk start positions
        chunk_len: torch.Tensor,     # [B] int valid tokens in each chunk
        *,
        max_pages: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Pools]:
        """One prompt chunk per slot: rows past ``chunk_len`` write the
        trash page (their logits are garbage the caller ignores), queries
        attend through the paged kernel's chunk variant. Returns
        (logits ``[B, C, V]`` f32, pools)."""
        _paged_guards(self.cfg, "prefill_chunk_paged", self.mesh is not None)
        b, c = tokens.shape
        dev = tokens.device
        start = torch.as_tensor(start, device=dev).to(torch.int32)
        if start.ndim == 0:
            start = start.expand(b)
        ar = torch.arange(c, dtype=torch.int32, device=dev)
        positions = start[:, None] + ar[None, :]
        valid = ar[None, :] < torch.as_tensor(chunk_len, device=dev)[:, None]
        tables = block_tables.to(torch.int32)
        x = self._embed(tokens, positions)
        x = self._layers(x, pools, tables, positions, valid, positions,
                         "chunk", max_pages)
        return self._logits(x), pools

    @torch.no_grad()
    def verify_chunk_paged(
        self,
        tokens: torch.Tensor,        # [B, C] int — [last token, drafts...]
        pools: Pools,                # layer-leading page pools (READ only)
        block_tables: torch.Tensor,  # [B, max_pages] int32
        start: torch.Tensor,         # [B] int — position of the chunk's row 0
        *,
        max_pages: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The speculative-decoding verify step with DEFERRED writes:
        nothing is written to the pools. Each layer's chunk K/V rows ride
        into the paged attention as in-flight keys (``variant="verify"``),
        read as a commit would store them (int8 pools: through the block
        codec; bf16 pools: in the pool dtype), so acceptance does not
        depend on when the rows are committed. Returns (logits
        ``[B, C, V]`` f32, chunk_k, chunk_v ``[L, B, C, Hkv, D]`` — the
        RAW rows; the caller commits the accepted prefix)."""
        _paged_guards(self.cfg, "verify_chunk_paged", self.mesh is not None)
        cfg = self.cfg
        b, c = tokens.shape
        dev = tokens.device
        start = torch.as_tensor(start, device=dev).to(torch.int32)
        if start.ndim == 0:
            start = start.expand(b)
        positions = start[:, None] + torch.arange(
            c, dtype=torch.int32, device=dev)[None, :]
        tables = block_tables.to(torch.int32)
        dt = getattr(torch, cfg.dtype)
        hkv, hd = cfg.kv_heads, cfg.head_dim

        def as_committed(rows, pools_l):
            if "k" in pools_l:
                return rows.to(pools_l["k"].dtype).contiguous()
            qv, sc = quant.kv_encode_rows(rows.reshape(b, c, hkv * hd),
                                          pools_l["k_q"].shape[-1])
            return quant.kv_decode_rows(qv, sc, dt).reshape(b, c, hkv, hd)

        x = self._embed(tokens, positions)
        rope = (_rope_tables(positions, hd, cfg.rope_theta)
                if cfg.pos == "rope" else None)
        scale = 1.0 if cfg.mup_base_width else hd ** -0.5
        chunk_k, chunk_v = [], []
        for i, layer in enumerate(self.layers):
            pools_l = layer_pools(pools, i)
            h = layer.ln1(x)
            q, k, v = _project_qkv(h, layer, cfg, rope, mup_full_scale=True)
            attn = paged_attention(
                q, pools_l, tables, positions, scale=scale,
                window=cfg.attn_window, kv_heads=hkv, max_pages=max_pages,
                variant="verify", extra_k=as_committed(k, pools_l),
                extra_v=as_committed(v, pools_l),
            ).reshape(b, c, cfg.n_head * hd)
            x = self._cache_layer_tail(x, _dense(attn, layer.attn.wo), layer)
            chunk_k.append(k)
            chunk_v.append(v)
        return self._logits(x), torch.stack(chunk_k), torch.stack(chunk_v)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

# remat policies of the JAX package that keep named residuals (save_attn,
# save_qkv, ...): not ported yet
_REMAT_NAMED = ("ROADMAP A21: remat policies that save named residuals "
                "are not ported yet; use remat='none' or 'full'")


def _norm_block(x, ln: Norm, cfg: ModelConfig, residual=None):
    """The layer-body norm. ``cfg.fused_norm`` True sends it to
    ``ops.norm.norm`` (the fused kernels on the card, their plain
    versions on the CPU), False to the plain ``_norm``; None (auto) means
    the kernel for a CUDA tensor and the plain ``_norm`` on the CPU. With
    ``residual``, returns ``(norm(x + residual), x + residual)``."""
    use_kernel = cfg.fused_norm
    if use_kernel is None:
        use_kernel = x.is_cuda
    if use_kernel:
        return fused_norm.norm(x, ln.scale, ln.bias, cfg.norm,
                               residual=residual)
    if residual is not None:
        h = x + residual
        return _norm(h, ln.scale, ln.bias, cfg.norm), h
    return _norm(x, ln.scale, ln.bias, cfg.norm)


def _attention_block(x, layer: Layer, cfg: ModelConfig, attn_fn, rope,
                     tp=None):
    """Attention; under tp ``wq`` column-parallel, its columns moved to
    the rank's heads as ``tp.mode`` says and the output back to them,
    ``wo`` row-parallel and summed over tp. A rank with no heads (a
    padded head block past ``n_head``) attends over nothing, its k and v
    kept in the graph so that every rank runs the same collectives in the
    backward."""
    b, s, _ = x.shape
    if tp is not None:
        x = copy_to_tp(x, tp.mesh)
    q, k, v = _project_qkv(x, layer, cfg, rope, mup_full_scale=False, tp=tp)
    out = attn_fn(q, k, v) if q.shape[2] else _KeepInGraph.apply(q, k, v)
    out = out.reshape(b, s, q.shape[2] * cfg.head_dim)
    if tp is not None:
        out = tp.out_cols(out)
    out = _dense(out, layer.attn.wo)
    return out if tp is None else reduce_from_tp(out, tp.mesh)


def _layer_body(x, layer: Layer, cfg: ModelConfig, attn_fn, rope,
                tp=None):
    h = _norm_block(x, layer.ln1, cfg)
    attn = _attention_block(h, layer, cfg, attn_fn, rope, tp)
    if cfg.parallel_residual:
        # GPTNeoX: both branches read the layer input
        h2 = _norm_block(x, layer.ln2, cfg)
    else:
        # the residual add rides in the norm kernel
        h2, x = _norm_block(x, layer.ln2, cfg, residual=attn)
    mlp_out = layer.mlp(h2, tp)
    return x + attn + mlp_out if cfg.parallel_residual else x + mlp_out


def run_trunk(x, model: "Decoder", positions, cfg: ModelConfig, attn_fn):
    """The layers over embedded inputs ``[B, S, D]`` → pre-final-norm
    hidden states. ``cfg.remat``: "none", or "full" (each layer under
    ``torch.utils.checkpoint``, non-reentrant: its activations are
    recomputed in backward, as ``jax.checkpoint`` over the scan body)."""
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={cfg.remat!r}: {_REMAT_NAMED}")
    rope = (_rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos == "rope" else None)

    def body(x, layer):
        return _layer_body(x, layer, cfg, attn_fn, rope, model.tp)

    for layer in model.layers:
        if cfg.remat == "full":
            x = checkpoint(body, x, layer, use_reentrant=False)
        else:
            x = body(x, layer)
    return x


def _sp_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("sp", 1)


def _attn_fn(cfg: ModelConfig, attn_impl: str, prefix_len, mesh=None):
    if attn_impl == "auto":
        # an sp mesh runs the sequence-parallel path, as the JAX forward
        attn_impl = "ulysses" if _sp_size(mesh) > 1 else "flash"

    def flash(q, k, v, **kw):
        return flash_attention(q, k, v, causal=cfg.causal,
                               head_pack=cfg.attn_head_pack, **kw)

    masks = dict(window=cfg.attn_window, prefix_len=prefix_len)
    if attn_impl in ("flash", "reference") and _sp_size(mesh) > 1:
        # each rank holds one sequence block: a local attention would see
        # only its own block
        raise ValueError(
            f"attn_impl={attn_impl!r} attends within one rank's sequence "
            f"block; an sp mesh (sp={_sp_size(mesh)}) needs \"ring\", "
            "\"ulysses\" or \"auto\"")
    if attn_impl == "flash":
        return lambda q, k, v: flash(q, k, v, **masks)
    if attn_impl == "reference":
        return lambda q, k, v: mha_reference(
            q, k, v, causal=cfg.causal, **masks)
    if attn_impl in ("ring", "ulysses") and mesh is None:
        raise ValueError(f"attn_impl={attn_impl!r} needs a mesh")
    if attn_impl == "ring":
        from dlrover_tpu_torch.parallel.sequence import ring_attention

        return lambda q, k, v: ring_attention(
            q, k, v, mesh, causal=cfg.causal, **masks)
    if attn_impl == "ulysses":
        from dlrover_tpu_torch.parallel.sequence import ulysses_attention

        return lambda q, k, v: ulysses_attention(
            q, k, v, mesh, causal=cfg.causal, attn_fn=flash, **masks)
    raise ValueError(f"unknown attn_impl {attn_impl!r}")


def forward(model: "Decoder", tokens, cfg: Optional[ModelConfig] = None,
            positions=None, attn_impl: str = "auto",
            features_only: bool = False, prefix_len=None, mesh=None):
    """tokens ``[B, S]`` → logits ``[B, S, V]`` f32, or with
    ``features_only`` the final-normed hidden states ``[B, S, D]``.
    ``attn_impl``: "auto" (flash, or under an sp mesh "ulysses"),
    "flash" (``ops.flash_attention``: the kernels on the card, their plain
    versions on the CPU), "reference" (``mha_reference``), "ring" or
    "ulysses" (``parallel/sequence.py``, over ``mesh``). Under a mesh
    ``tokens`` is this rank's block, ``[B_l, S_l]``, at global positions
    ``sp rank · S_l + arange(S_l)``; ``prefix_len`` stays global. ``cfg``
    defaults to the model's."""
    cfg = model.cfg if cfg is None else cfg
    b, s = tokens.shape
    if positions is None:
        first = 0 if mesh is None else mesh.coord("sp") * s
        positions = torch.arange(first, first + s,
                                 device=tokens.device).expand(b, s)
    if cfg.prefix_lm and prefix_len is None:
        raise ValueError(
            "cfg.prefix_lm is set but no prefix_len was provided; pass "
            "zeros for fully-causal behavior")
    x = model._embed(tokens, positions)
    x = run_trunk(x, model, positions, cfg,
                  _attn_fn(cfg, attn_impl, prefix_len, mesh))
    x = _norm_block(x, model.final_norm, cfg)
    if features_only:
        return x
    w_out, head_scale = head_weight_scale(model, cfg)
    if model.tp is not None:
        x = copy_to_tp(x, model.tp.mesh)
    logits = _mm_f32(x.reshape(b * s, -1), w_out.to(x.dtype))
    if head_scale != 1.0:
        logits = logits * head_scale
    logits = logits.reshape(b, s, -1)
    if model.tp is not None:
        logits = gather_from_tp(logits, -1, model.tp.mesh)
    return logits


def head_weight_scale(model: "Decoder", cfg: Optional[ModelConfig] = None):
    """(lm-head weight ``[D, V]`` as a view of the parameter, static logit
    multiplier). The muP readout multiplier applies only to a tied head.
    Sharded, the weight is this tp rank's vocab block ``[D, V/tp]``, its
    fsdp-cut dim gathered (in the parameter's dtype)."""
    cfg = model.cfg if cfg is None else cfg
    if cfg.tie_embeddings:
        w = _use(model.embed.tokens, model.embed,
                 model.embed.tokens.dtype).t()
    else:
        w = _use(model.lm_head.weight, model.lm_head,
                 model.lm_head.weight.dtype).t()
    scale = 1.0
    if cfg.mup_base_width and cfg.tie_embeddings:
        scale = cfg.mup_base_width / cfg.d_model
    return w, scale


def loss_fn(model: "Decoder", batch: Dict[str, torch.Tensor],
            cfg: Optional[ModelConfig] = None, z_loss: float = 0.0,
            attn_impl: str = "auto", denom=None, mesh=None):
    """``(loss, metrics)`` for ``batch`` {"tokens" [B, S], "targets"
    [B, S], optional "mask" [B, S], optional "prefix_len" [B]}: masked
    mean NLL over ``denom`` (default the mask's sum), plus ``z_loss`` ·
    mean logz² when set. ``cfg.fused_ce`` runs the head through
    ``fused_linear_ce``; otherwise the full f32 logits. Metrics: loss,
    tokens, accuracy (and z_loss), detached. Under a ``mesh`` the batch
    is this rank's block (``forward``) and ``denom`` the global one;
    under tp the head and loss are vocab-parallel
    (``vocab_parallel_ce``, fused or not as ``cfg.fused_ce`` says)."""
    cfg = model.cfg if cfg is None else cfg
    targets = batch["targets"]
    kw = dict(cfg=cfg, attn_impl=attn_impl,
              prefix_len=batch.get("prefix_len"), mesh=mesh)
    if model.tp is not None:
        feats = forward(model, batch["tokens"], features_only=True, **kw)
        w_out, head_scale = head_weight_scale(model, cfg)
        vl = model.tp.vocab_size
        bv = min(cfg.ce_block_v, (vl + 127) // 128 * 128)
        logz, tgt_logit, amax = vocab_parallel_ce(
            copy_to_tp(feats, model.tp.mesh), w_out, targets, head_scale,
            bv, model.tp.vocab_start, model.tp.mesh, fused=cfg.fused_ce)
    elif cfg.fused_ce:
        feats = forward(model, batch["tokens"], features_only=True, **kw)
        w_out, head_scale = head_weight_scale(model, cfg)
        bv = min(cfg.ce_block_v, (cfg.vocab_size + 127) // 128 * 128)
        logz, tgt_logit, amax = fused_linear_ce(feats, w_out, targets,
                                                head_scale, bv)
    else:
        logits = forward(model, batch["tokens"], **kw)
        logz = torch.logsumexp(logits, dim=-1)
        tgt_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
        amax = logits.argmax(-1)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    mask = mask.float()
    nll = (logz - tgt_logit) * mask
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    metrics = {"loss": loss.detach(), "tokens": mask.sum()}
    if z_loss > 0.0:
        zl = z_loss * torch.sum((logz * mask) ** 2) / denom
        loss = loss + zl
        metrics["z_loss"] = zl.detach()
    acc = (amax == targets).float() * mask
    metrics["accuracy"] = (acc.sum() / denom).detach()
    return loss, metrics


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         trainable: bool = False, mesh=None) -> Decoder:
    """A ``Decoder`` on ``device`` with weights drawn from ``seed`` (this
    rank's shards of them under a sharded ``mesh``)."""
    dev = resolve_device(device)
    model = Decoder(cfg, device=dev, trainable=trainable, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return model.init_weights(gen)
