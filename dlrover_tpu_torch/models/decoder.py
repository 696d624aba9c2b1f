"""Decoder-only transformer: the paged serving (decode) family.

Port of the serving half of ``dlrover_tpu/models/decoder.py`` as an
``nn.Module``: ``init`` (same parameter names and shapes, matrices in
``nn.Linear``'s ``[out, in]`` layout, drawn from a ``torch.Generator``),
``_norm``, ``_rope_tables``/``_rope``, ``_project_qkv`` and
``_mlp_block`` (no fp8, no mesh), ``_cache_layer_tail`` (dense, with
``parallel_residual``), ``_paged_guards``, ``decode_step_paged`` and
``prefill_chunk_paged``.

For serving, matrices are stored in the compute dtype (``cfg.dtype``).
JAX keeps f32 params and casts each weight with ``.astype(x.dtype)`` at
every use, so the numbers are the same. Norm scales and biases stay
f32, as JAX reads them. Logits are f32: the head runs on the f32 upcast
of its bf16 operands, which is what JAX's ``preferred_element_type=f32``
computes.

The paged steps write each new K/V row into its page cell IN PLACE
(``ops.paged_attention.write_page_rows``) and attend through
``ops.paged_attention.paged_attention`` — the hand-written CUDA kernel
on the card, its plain PyTorch version on the CPU. No contiguous
``[L, B, S, ...]`` cache exists anywhere.
"""

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.config import ModelConfig
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
        if self.act == "swiglu":
            h = F.silu(self.w_gate(x)) * self.w_up(x)
        else:
            h = F.gelu(self.w_up(x), approximate="tanh")
        return self.w_down(h)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg, dtype, device)


class Decoder(nn.Module):
    """The decoder's parameters and its paged serving steps.

    ``Decoder(cfg)`` allocates on ``device`` (default ``"cuda"``; raises
    without a card) with uninitialized weights: fill them with
    ``init_weights`` or ``models.convert.load_jax_params``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "MoE decoders are not ported yet (ROADMAP A16)"
            )
        dev = resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = Table("tokens", (v, d), dt, dev)
        if cfg.pos == "learned":
            self.pos_embed = Table("table", (cfg.max_seq, d), dt, dev)
        self.layers = nn.ModuleList(
            Layer(cfg, dt, dev) for _ in range(cfg.n_layer)
        )
        self.final_norm = Norm(d, cfg.norm, dev)
        self.lm_head = None if cfg.tie_embeddings else _linear(d, v, dt, dev)

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
        cfg = self.cfg
        x = self.embed.tokens[tokens.long()]
        if cfg.pos == "learned":
            x = x + self.pos_embed.table[positions.long()]
        return x

    def _project_qkv(self, x, layer: Layer, rope):
        """QKV projection + rope + muP q-scaling (the cache paths run
        attention at scale 1 under muP, so q carries all of 1/d)."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nkv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
        q = layer.attn.wq(x).reshape(b, s, nh, hd)
        k = layer.attn.wk(x).reshape(b, s, nkv, hd)
        v = layer.attn.wv(x).reshape(b, s, nkv, hd)
        if rope is not None:
            q = _rope(q, rope)
            k = _rope(k, rope)
        if cfg.mup_base_width:
            q = q * (hd ** -1.0)
        return q, k, v

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
            q, k, v = self._project_qkv(h, layer, rope)
            # write-before-attend: the new rows are keys of this step
            write_page_rows(pools_l, tables, positions, write_valid, k, v)
            attn = paged_attention(
                q, pools_l, tables, attn_pos, scale=scale,
                window=cfg.attn_window, kv_heads=cfg.kv_heads,
                max_pages=max_pages, variant=variant,
            ).reshape(b, c, cfg.n_head * cfg.head_dim)
            x = self._cache_layer_tail(x, layer.attn.wo(attn), layer)
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


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Decoder:
    """A ``Decoder`` on ``device`` with weights drawn from ``seed``."""
    dev = resolve_device(device)
    model = Decoder(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return model.init_weights(gen)
