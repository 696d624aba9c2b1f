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
fp8, MoE, pipeline or mesh).

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
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.ops import norm as fused_norm
from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.ops.attention import mha_reference
from dlrover_tpu_torch.ops.fused_ce import _mm_f32, fused_linear_ce
from dlrover_tpu_torch.ops.flash_attention import flash_attention
from dlrover_tpu_torch.ops.paged_attention import (
    paged_attention,
    write_page_rows,
)
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
                 mup_full_scale: bool):
    """QKV projection + rope + muP q-scaling. muP wants 1/d_head of
    attention scaling in all: the training attention applies
    1/sqrt(d_head) itself, so q carries the other half; the cache paths
    run attention at scale 1 and set ``mup_full_scale``."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    q = _dense(x, layer.attn.wq).reshape(b, s, nh, hd)
    k = _dense(x, layer.attn.wk).reshape(b, s, nkv, hd)
    v = _dense(x, layer.attn.wv).reshape(b, s, nkv, hd)
    if rope is not None:
        q = _rope(q, rope)
        k = _rope(k, rope)
    if cfg.mup_base_width:
        q = q * (hd ** (-1.0 if mup_full_scale else -0.5))
    return q, k, v


def _paged_guards(cfg: ModelConfig, fn: str):
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
# Modules
# ---------------------------------------------------------------------------


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``x @ w.astype(x.dtype)``: the weight cast to the activations'
    dtype at its use (a no-op for serving's compute-dtype weights)."""
    return F.linear(x, lin.weight.to(x.dtype))


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


def _linear(n_in, n_out, dtype, device) -> nn.Linear:
    lin = nn.Linear(n_in, n_out, bias=False, dtype=dtype, device=device)
    lin.weight.requires_grad_(False)
    return lin


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, nh, nkv, hd = cfg.d_model, cfg.n_head, cfg.kv_heads, cfg.head_dim
        self.wq = _linear(d, nh * hd, dtype, device)
        self.wk = _linear(d, nkv * hd, dtype, device)
        self.wv = _linear(d, nkv * hd, dtype, device)
        self.wo = _linear(nh * hd, d, dtype, device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = cfg.act
        if cfg.act == "swiglu":
            self.w_gate = _linear(d, f, dtype, device)
        self.w_up = _linear(d, f, dtype, device)
        self.w_down = _linear(f, d, dtype, device)

    def forward(self, x):
        """``_mlp_block``: swiglu ``silu(x·Wg) * (x·Wu)`` or tanh-gelu."""
        if self.act == "swiglu":
            h = F.silu(_dense(x, self.w_gate)) * _dense(x, self.w_up)
        else:
            h = F.gelu(_dense(x, self.w_up), approximate="tanh")
        return _dense(h, self.w_down)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg, dtype, device)


class Decoder(nn.Module):
    """The decoder's parameters, its paged serving steps, and (through
    the module functions ``forward``/``loss_fn``) its training forward.

    ``Decoder(cfg)`` allocates on ``device`` (default ``"cuda"``; raises
    without a card) with uninitialized weights: fill them with
    ``init_weights`` or ``models.convert.load_jax_params``. Serving
    weights are frozen in ``cfg.dtype``; ``trainable=True`` keeps every
    parameter trainable in ``cfg.param_dtype`` instead."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 trainable: bool = False):
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "MoE decoders are not ported yet (ROADMAP A16)"
            )
        dev = resolve_device(device)
        dt = getattr(torch, cfg.param_dtype if trainable else cfg.dtype)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = Table("tokens", (v, d), dt, dev)
        if cfg.pos == "learned":
            self.pos_embed = Table("table", (cfg.max_seq, d), dt, dev)
        self.layers = nn.ModuleList(
            Layer(cfg, dt, dev) for _ in range(cfg.n_layer)
        )
        self.final_norm = Norm(d, cfg.norm, dev)
        self.lm_head = (None if cfg.tie_embeddings
                        else _linear(d, v, dt, dev))
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.tokens.device

    # ---- init --------------------------------------------------------------

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Decoder":
        """Draw every matrix as N(0, 1) / sqrt(fan_in) (the embedding
        N(0, 0.02²), learned positions N(0, 0.01²)) from ``generator``,
        whose device must be the model's; norms to 1/0 — the scales of
        the JAX ``init``, not its bits."""
        dev = self.device

        def draw(p: torch.Tensor, std: float):
            x = torch.randn(p.shape, generator=generator, device=dev,
                            dtype=torch.float32)
            p.copy_(x.mul_(std))

        draw(self.embed.tokens, 0.02)
        if self.cfg.pos == "learned":
            draw(self.pos_embed.table, 0.01)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                draw(mod.weight, 1.0 / math.sqrt(mod.in_features))
            elif isinstance(mod, Norm):
                mod.scale.fill_(1.0)
                if mod.bias is not None:
                    mod.bias.zero_()
        return self

    # ---- pieces ------------------------------------------------------------

    def _embed(self, tokens, positions):
        """Token (and learned position) rows, cast to ``cfg.dtype``."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x = self.embed.tokens[tokens.long()].to(dt)
        if cfg.pos == "learned":
            x = x + self.pos_embed.table[positions.long()].to(dt)
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
        _paged_guards(self.cfg, "decode_step_paged")
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
        _paged_guards(self.cfg, "prefill_chunk_paged")
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
        _paged_guards(self.cfg, "verify_chunk_paged")
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


def _attention_block(x, layer: Layer, cfg: ModelConfig, attn_fn, rope):
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, layer, cfg, rope, mup_full_scale=False)
    out = attn_fn(q, k, v).reshape(b, s, cfg.n_head * cfg.head_dim)
    return _dense(out, layer.attn.wo)


def _layer_body(x, layer: Layer, cfg: ModelConfig, attn_fn, rope):
    h = _norm_block(x, layer.ln1, cfg)
    attn = _attention_block(h, layer, cfg, attn_fn, rope)
    if cfg.parallel_residual:
        # GPTNeoX: both branches read the layer input
        h2 = _norm_block(x, layer.ln2, cfg)
    else:
        # the residual add rides in the norm kernel
        h2, x = _norm_block(x, layer.ln2, cfg, residual=attn)
    mlp_out = layer.mlp(h2)
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
        return _layer_body(x, layer, cfg, attn_fn, rope)

    for layer in model.layers:
        if cfg.remat == "full":
            x = checkpoint(body, x, layer, use_reentrant=False)
        else:
            x = body(x, layer)
    return x


def _attn_fn(cfg: ModelConfig, attn_impl: str, prefix_len):
    if attn_impl in ("auto", "flash"):
        return lambda q, k, v: flash_attention(
            q, k, v, causal=cfg.causal, window=cfg.attn_window,
            prefix_len=prefix_len, head_pack=cfg.attn_head_pack)
    if attn_impl == "reference":
        return lambda q, k, v: mha_reference(
            q, k, v, causal=cfg.causal, window=cfg.attn_window,
            prefix_len=prefix_len)
    raise NotImplementedError(
        f"attn_impl={attn_impl!r}: ring and ulysses attention wait for "
        "the sequence-parallel port (ROADMAP A16)")


def forward(model: "Decoder", tokens, cfg: Optional[ModelConfig] = None,
            positions=None, attn_impl: str = "auto",
            features_only: bool = False, prefix_len=None):
    """tokens ``[B, S]`` → logits ``[B, S, V]`` f32, or with
    ``features_only`` the final-normed hidden states ``[B, S, D]``.
    ``attn_impl``: "auto"/"flash" (``ops.flash_attention``: the kernels
    on the card, their plain versions on the CPU) or "reference"
    (``mha_reference``). ``cfg`` defaults to the model's."""
    cfg = model.cfg if cfg is None else cfg
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    if cfg.prefix_lm and prefix_len is None:
        raise ValueError(
            "cfg.prefix_lm is set but no prefix_len was provided; pass "
            "zeros for fully-causal behavior")
    x = model._embed(tokens, positions)
    x = run_trunk(x, model, positions, cfg, _attn_fn(cfg, attn_impl,
                                                     prefix_len))
    x = _norm_block(x, model.final_norm, cfg)
    if features_only:
        return x
    w_out, head_scale = head_weight_scale(model, cfg)
    logits = _mm_f32(x.reshape(b * s, -1), w_out.to(x.dtype))
    if head_scale != 1.0:
        logits = logits * head_scale
    return logits.reshape(b, s, -1)


def head_weight_scale(model: "Decoder", cfg: Optional[ModelConfig] = None):
    """(lm-head weight ``[D, V]`` as a view of the parameter, static logit
    multiplier). The muP readout multiplier applies only to a tied head."""
    cfg = model.cfg if cfg is None else cfg
    if cfg.tie_embeddings:
        w = model.embed.tokens.t()
    else:
        w = model.lm_head.weight.t()
    scale = 1.0
    if cfg.mup_base_width and cfg.tie_embeddings:
        scale = cfg.mup_base_width / cfg.d_model
    return w, scale


def loss_fn(model: "Decoder", batch: Dict[str, torch.Tensor],
            cfg: Optional[ModelConfig] = None, z_loss: float = 0.0,
            attn_impl: str = "auto", denom=None):
    """``(loss, metrics)`` for ``batch`` {"tokens" [B, S], "targets"
    [B, S], optional "mask" [B, S], optional "prefix_len" [B]}: masked
    mean NLL over ``denom`` (default the mask's sum), plus ``z_loss`` ·
    mean logz² when set. ``cfg.fused_ce`` runs the head through
    ``fused_linear_ce``; otherwise the full f32 logits. Metrics: loss,
    tokens, accuracy (and z_loss), detached."""
    cfg = model.cfg if cfg is None else cfg
    targets = batch["targets"]
    kw = dict(cfg=cfg, attn_impl=attn_impl,
              prefix_len=batch.get("prefix_len"))
    if cfg.fused_ce:
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
         trainable: bool = False) -> Decoder:
    """A ``Decoder`` on ``device`` with weights drawn from ``seed``."""
    dev = resolve_device(device)
    model = Decoder(cfg, device=dev, trainable=trainable)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return model.init_weights(gen)
