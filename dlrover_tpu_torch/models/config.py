"""Model configurations for the flagship decoder family.

Sizes mirror the models the reference benchmarks with
(GPT-2 1.5B for flash-checkpoint, Llama2-7B for ATorch throughput —
BASELINE.md #3-#11), plus small configs for tests and CI.

The port's copy of ``dlrover_tpu/models/config.py``, kept field for
field (the JAX copy cannot be imported without JAX, because
``dlrover_tpu/models/__init__.py`` imports the decoder). The comments
on TPU tiling and kernels describe the JAX package; the port reads the
same fields.
"""

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 50304          # padded to a multiple of 128 for the MXU
    n_layer: int = 2
    n_head: int = 4
    n_kv_head: Optional[int] = None  # GQA; None = n_head
    d_model: int = 128
    d_ff: int = 512
    max_seq: int = 256
    # architecture family
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    pos: str = "rope"                # rope | learned
    # False = bidirectional attention (BERT-family encoders; the TP/SP
    # machinery is identical — same weights, different mask)
    causal: bool = True
    # GLM-family prefix-LM (reference: atorch's TP GLM blocks,
    # distributed_modules/transformer.py:270): bidirectional attention
    # over a per-sequence prefix, causal over the tail. The prefix
    # lengths arrive at runtime as batch["prefix_len"] ([B] int32).
    prefix_lm: bool = False
    # GPTNeoX/GPT-J-style parallel residual (reference: atorch's TP
    # GPTNeoX blocks, transformer.py:838): attention and MLP both read
    # the same layer input, x = x + attn(ln1 x) + mlp(ln2 x) — shortens
    # the critical path and lets XLA overlap the two matmul chains
    parallel_residual: bool = False
    # Mistral-style sliding-window attention (0 = unlimited): each query
    # attends to the last attn_window positions. Causal only; mutually
    # exclusive with prefix_lm. The flash kernel skips (and never DMAs)
    # blocks outside the window, so attention cost is O(S·window).
    attn_window: int = 0
    # flash-kernel tile sizes (128-multiples; tunable by strategy search).
    # 1024 measured +12% step throughput over 512 on v5e at s=1024
    # (less grid overhead); _fit_block caps them to the actual sequence.
    attn_block_q: int = 1024
    attn_block_k: int = 1024
    # heads per flash-kernel program (narrow-head packing; 0 = auto:
    # 128 // head_dim when head_dim < 128 and the layout is MHA, so
    # gpt2-family d=64 shapes amortize mask/iota work and grid overhead
    # across 2 heads per program; 1 disables)
    attn_head_pack: int = 0
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # numerics
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    # rematerialisation policy:
    # none | full | dots_saveable | save_attn | save_qkv |
    # save_qkv_gate | save_dots | offload_attn | save_qkv_offload
    # (save_qkv/save_qkv_gate/save_dots = save_attn plus the qkv /
    # qkv+gate / qkv+gate+up matmul outputs — graded memory/recompute
    # tradeoffs between full and dots_saveable; offload_attn =
    # save_attn with residuals in pinned host memory — reference:
    # atorch selective_offloading_checkpoint.py; save_qkv_offload =
    # save_qkv's residual set offloaded the same way, for models whose
    # pinned save_qkv residuals OOM the chip but full remat's ~30%
    # backward recompute is too slow — e.g. gpt2-1.5b's tied 50k-vocab
    # embedding)
    remat: str = "none"
    # dtype the NAMED remat residuals are stored in (None = compute
    # dtype). "bfloat16" halves pinned/offloaded residual bytes; the
    # values re-enter backward matmuls that run in bf16 anyway, so the
    # precision loss is confined to the storage round-trip.
    remat_dtype: Optional[str] = None
    # MoE (0 = dense)
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_gating: str = "topk"         # topk | switch (top-1 w/ jitter)
    moe_jitter: float = 0.0          # switch-gating router noise (train only)
    moe_aux_coef: float = 0.0        # load-balancing loss coefficient
    moe_z_coef: float = 0.0          # router z-loss coefficient
    moe_alltoall: bool = False       # explicit shard_map all-to-all dispatch
    moe_impl: str = "dense"          # dense (capacity) | ragged (dropless)
    # ragged+ep: per-destination all-to-all buffer bound, as a multiple
    # of the balanced share (t·k/ep). Memory/wire bound ONLY — compute
    # stays ragged; tokens past the bound drop. ep (the worst case)
    # guarantees droplessness at ep× wire cost.
    moe_a2a_bound: float = 2.0
    # pipeline microbatches when the mesh has pp > 1 (0 → one per stage)
    pp_microbatches: int = 0
    # interleaved (circular) pipeline: v layer chunks per stage cut the
    # bubble to (P−1)/(M·v+P−1). The chunk→stage assignment permutes the
    # semantic layer order, so v>1 requires pp_stages to pin the stage
    # count the layout was built for (checkpoints stay well-defined on
    # other meshes via parallel.pipeline.semantic_layer_perm).
    pp_interleave: int = 1
    pp_stages: int = 0
    # stage-hop dtype override; None rides hops at the compute dtype
    # (bf16 models → half the ICI bytes, numerically free — see
    # parallel/pipeline.py module doc). Set "float32" to force wide hops.
    pp_boundary_dtype: Optional[str] = None
    # muP (train/mup.py): width of the base model hyperparams were tuned
    # at; None = standard parametrization. When set, attention uses 1/d
    # scaling and tied logits get the 1/width_mult MuReadout multiplier.
    mup_base_width: Optional[int] = None
    # fused lm-head cross-entropy (ops/fused_ce.py): chunk the vocab
    # axis with online logsumexp so the [B*S, vocab] f32 logits tensor
    # (~1 GiB at b8*s1024*v32k) never materializes. loss_fn falls back
    # to the unfused path automatically when the vocab axis is
    # tp-sharded (Megatron-style vocab parallelism splits the head
    # weight across chips; the chunk scan would force a gather).
    fused_ce: bool = True
    ce_block_v: int = 4096           # vocab chunk width (128-multiple)
    # fp8 GEMMs with delayed scaling in the MLP projections
    # (ops/fp8.py): forward operands e4m3, gradients e5m2, per-tensor
    # scales from rolling amax histories threaded through the train
    # state (state["fp8"], updated via the state-on-cotangent
    # convention). Numerics are identical on every backend (pre-fp8
    # chips upcast the already-quantized values to bf16); the
    # accelerate strategy enables it by default only where the MXU
    # consumes fp8 natively (v6e+, device_context.fp8_supported).
    fp8: bool = False
    # fused norm/residual kernels (ops/pallas_norm.py): rmsnorm /
    # layernorm with f32 statistics in one VMEM visit, and the
    # pre-norm residual add folded into the same kernel so
    # `x + attn_out -> norm(...)` is one HBM round-trip instead of
    # three. None = auto (on when the Pallas TPU path is available,
    # jnp fallback elsewhere — CPU/GPU programs are byte-identical to
    # the unfused build); True/False force it either way.
    fused_norm: Optional[bool] = None

    def __post_init__(self):
        if self.moe_impl not in ("dense", "ragged"):
            raise ValueError(
                f"moe_impl must be 'dense' or 'ragged', got "
                f"{self.moe_impl!r}"
            )
        if self.moe_gating not in ("topk", "switch"):
            raise ValueError(
                f"moe_gating must be 'topk' or 'switch', got "
                f"{self.moe_gating!r}"
            )
        if self.remat not in (
            "none", "full", "dots_saveable", "save_attn", "save_qkv",
            "save_qkv_gate", "save_dots", "offload_attn",
            "save_qkv_offload",
        ):
            # a typo'd policy would silently train with NO remat and
            # OOM configs that only fit WITH one — fail at build time
            raise ValueError(f"unknown remat policy {self.remat!r}")
        if self.remat_dtype is not None and self.remat_dtype not in (
            "bfloat16", "float32",
        ):
            raise ValueError(
                f"remat_dtype must be None, 'bfloat16' or 'float32', "
                f"got {self.remat_dtype!r}"
            )
        if self.attn_head_pack < 0:
            raise ValueError(
                f"attn_head_pack must be >= 0, got {self.attn_head_pack}"
            )
        for name in ("attn_block_q", "attn_block_k"):
            b = getattr(self, name)
            if b <= 0 or b % 128:
                raise ValueError(
                    f"{name} must be a positive multiple of 128, got {b}"
                )
        if self.attn_window:
            if self.attn_window < 0:
                raise ValueError(
                    f"attn_window must be >= 0, got {self.attn_window}"
                )
            if not self.causal:
                raise ValueError("attn_window requires causal=True")
            if self.prefix_lm:
                raise ValueError(
                    "attn_window and prefix_lm are mutually exclusive"
                )

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    def num_params(self) -> int:
        """Approximate parameter count (dense part)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layer
        attn = d * d + 2 * d * self.kv_heads * self.head_dim + d * d
        mlp = (3 if self.act == "swiglu" else 2) * d * f
        per_layer = attn + mlp + 2 * d
        embed = v * d * (1 if self.tie_embeddings else 2)
        pos = self.max_seq * d if self.pos == "learned" else 0
        return L * per_layer + embed + pos + d

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token ≈ 6·N + attention term (fwd+bwd).

        A sliding window caps each query's attention span, so windowed
        configs do O(S·window) attention work, not O(S²)."""
        n = self.num_params()
        span = (
            min(seq_len, self.attn_window)
            if self.attn_window
            else seq_len
        )
        attn_flops = 12 * self.n_layer * self.d_model * span
        return 6.0 * n + attn_flops


def mup_base_config(cfg: "ModelConfig") -> "ModelConfig":
    """The base-width twin of ``cfg`` for muP infshape computation.

    Width dims (d_model, d_ff, heads) shrink to ``mup_base_width``
    proportionally with head_dim held constant — depth, vocab and seq are
    muP-invariant and stay put.
    """
    if not cfg.mup_base_width:
        raise ValueError("cfg.mup_base_width is not set")
    ratio = cfg.mup_base_width / cfg.d_model
    return replace(
        cfg,
        d_model=cfg.mup_base_width,
        d_ff=max(int(cfg.d_ff * ratio), 1),
        n_head=max(int(cfg.n_head * ratio), 1),
        n_kv_head=(
            max(int(cfg.kv_heads * ratio), 1)
            if cfg.n_kv_head is not None
            else None
        ),
    )


def _gpt2(name, n_layer, n_head, d_model, max_seq=1024):
    return ModelConfig(
        name=name,
        vocab_size=50304,
        n_layer=n_layer,
        n_head=n_head,
        d_model=d_model,
        d_ff=4 * d_model,
        max_seq=max_seq,
        norm="layernorm",
        act="gelu",
        pos="learned",
        tie_embeddings=True,
    )


def _llama(name, n_layer, n_head, d_model, d_ff, max_seq=4096, n_kv_head=None):
    return ModelConfig(
        name=name,
        vocab_size=32000,
        n_layer=n_layer,
        n_head=n_head,
        n_kv_head=n_kv_head,
        d_model=d_model,
        d_ff=d_ff,
        max_seq=max_seq,
        norm="rmsnorm",
        act="swiglu",
        pos="rope",
        tie_embeddings=False,
    )


def _bert(name, n_layer, n_head, d_model, max_seq=512):
    """BERT-family encoder (reference: atorch's TP BERT blocks,
    distributed_modules/transformer.py:45): bidirectional attention,
    learned positions, layernorm+gelu, tied MLM head."""
    return ModelConfig(
        name=name,
        vocab_size=30592,            # 30522 padded to a 128 multiple
        n_layer=n_layer,
        n_head=n_head,
        d_model=d_model,
        d_ff=4 * d_model,
        max_seq=max_seq,
        causal=False,
        pos="learned",
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
    )


def _gptneox(name, n_layer, n_head, d_model, max_seq=2048):
    return ModelConfig(
        name=name,
        vocab_size=50432,
        n_layer=n_layer,
        n_head=n_head,
        d_model=d_model,
        d_ff=4 * d_model,
        max_seq=max_seq,
        norm="layernorm",
        act="gelu",
        pos="rope",
        parallel_residual=True,
        tie_embeddings=False,
    )


def _glm(name, n_layer, n_head, d_model, max_seq=2048):
    """GLM-family prefix-LM decoder (bidirectional prefix + causal tail).
    Design divergence from the reference's GLM blocks: rope instead of
    GLM's 2D block positions — the infilling capability lives in the
    prefix mask, and rope needs no learned table."""
    return ModelConfig(
        name=name,
        vocab_size=50304,
        n_layer=n_layer,
        n_head=n_head,
        d_model=d_model,
        d_ff=4 * d_model,
        max_seq=max_seq,
        norm="layernorm",
        act="gelu",
        pos="rope",
        prefix_lm=True,
        tie_embeddings=True,
    )


CONFIGS = {
    "tiny": ModelConfig(),
    "tiny-moe": replace(ModelConfig(name="tiny-moe"), n_experts=4),
    "tiny-neox": replace(
        ModelConfig(name="tiny-neox"),
        parallel_residual=True,
        norm="layernorm",
        act="gelu",
    ),
    "tiny-glm": replace(ModelConfig(name="tiny-glm"), prefix_lm=True),
    "tiny-bert": replace(
        ModelConfig(name="tiny-bert"),
        causal=False,
        pos="learned",
        norm="layernorm",
        act="gelu",
    ),
    "bert-base": _bert("bert-base", 12, 12, 768),
    "bert-large": _bert("bert-large", 24, 16, 1024),
    "gpt2-124m": _gpt2("gpt2-124m", 12, 12, 768),
    "gpt2-355m": _gpt2("gpt2-355m", 24, 16, 1024),
    "gpt2-1.5b": _gpt2("gpt2-1.5b", 48, 25, 1600),
    # single-chip flagship: llama proportions sized for one v5e, with
    # every hot dim a 128-multiple (d=16·128, head_dim=128, ff=44·128) —
    # measured ~10pt better raw matmul efficiency than gpt2-1.5b's
    # d=1600/head_dim=64 shapes on the v5e MXU
    "llama-1.4b": _llama("llama-1.4b", 24, 16, 2048, 5632),
    "llama-1.7b": _llama("llama-1.7b", 24, 18, 2304, 6144),
    "llama2-7b": _llama("llama2-7b", 32, 32, 4096, 11008),
    "llama2-13b": _llama("llama2-13b", 40, 40, 5120, 13824),
    "llama3-8b": _llama(
        "llama3-8b", 32, 32, 4096, 14336, max_seq=8192, n_kv_head=8
    ),
    "gptneox-20b": _gptneox("gptneox-20b", 44, 64, 6144),
    "glm-10b": _glm("glm-10b", 48, 64, 4096),
    # sliding-window flagship: Mistral-style decoder (GQA + 4k window;
    # attention cost O(S·window) — the kernel never touches blocks
    # outside the window)
    "mistral-7b": replace(
        _llama(
            "mistral-7b", 32, 32, 4096, 14336,
            max_seq=8192, n_kv_head=8,
        ),
        attn_window=4096,
    ),
    # sparse flagship: Mixtral-style MoE decoder (GQA + top-2 routing);
    # the ep mesh axis + explicit all-to-all dispatch carry it
    "mixtral-8x7b": replace(
        _llama(
            "mixtral-8x7b", 32, 32, 4096, 14336,
            max_seq=8192, n_kv_head=8,
        ),
        n_experts=8,
        expert_top_k=2,
        moe_aux_coef=0.01,
        moe_z_coef=0.001,
        moe_alltoall=True,  # ep>1 meshes must not replicate expert acts
    ),
}


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = CONFIGS[name]
    return replace(cfg, **overrides) if overrides else cfg
