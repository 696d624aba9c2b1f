"""Paged attention over the serving tier's block-table KV pools.

Port of ``dlrover_tpu/ops/pallas_paged.py``:

- ``paged_attention`` — the op. On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/paged_attention.cu`` (which replaces
  the TPU kernel ``pallas_paged.py::_paged_kernel``) or raises; on a CPU
  tensor it runs ``paged_attention_reference``. There is no other path:
  a failed build or launch raises, it never falls back.
- ``paged_attention_reference`` — the plain PyTorch version, op for op
  the JAX reference: gather ONLY the pages the block table names, then
  the dense cached attention. ``decode`` keeps the probabilities in f32
  through P·V; ``chunk`` casts them to ``q.dtype`` first (mirroring
  ``mha_reference``); ``verify`` runs the decode math per query over the
  committed keys plus the in-flight chunk rows. The decode and verify
  kernels keep f32 throughout; the bf16 chunk kernel rounds the
  unnormalized probabilities to bf16 before P·V, as the flash kernels
  do. Each matches the plain version to a stated bound, not bitwise.
- ``write_page_rows`` / ``gather_pages`` — the page-level tensor ops the
  decoder and the reference share.
- ``plan_splits`` / ``plan_chunk_splits`` / ``split_columns`` /
  ``chunk_split_keys`` — how the decode and verify kernel
  (``paged_decode_split_kernel``: contiguous table columns) and the
  tensor-core chunk kernel (``paged_chunk_wgmma_kernel``: contiguous
  tiles of the keys its rows may see) split each row tile's page walk
  across blocks: how many splits, from the launch shape and the SM count
  only, so a call needs no device read. Each split's partial (m, l, acc)
  goes to a per-device workspace the wrapper keeps (``_workspace``); the
  last split to finish merges them in split order, so the output is the
  same on every call and, up to f32 rounding, for any split count.

Several serve loops may call the kernels from their own threads in one
process (a disaggregated fleet). Calls that share a device's workspace
must run in order, so they must run on one stream: the workspace belongs
to the stream of its first call, and a call on another stream raises
(a CUDA-graph capture only records, and is let through). A lock holds
the workspace's growth, the launch and the ``LAUNCHES`` count together,
so one thread cannot free a workspace another is about to launch into.

``verify`` is the speculative-decoding verify step: the C queries are a
draft chunk whose K/V rows (``extra_k``/``extra_v`` ``[B, C, Hkv, D]``,
at ``positions`` themselves) are IN FLIGHT — folded as extra keys, never
written to the pools. Committed keys mask at ``kpos < positions[:, 0]``
(pool cells at chunk positions may hold another tenant's stale rows) and
in-flight key i serves query j iff i <= j (and the window).

Pools are one layer's slices: bf16 (or f32) ``{"k", "v"}`` of
``[n_pages, ps, Hkv, D]``, or int8 ``{"k_q", "k_scale", "v_q",
"v_scale"}`` of ``[n_pages, ps, nb, blk]`` payloads and
``[n_pages, ps, nb]`` f32 scales. Page 0 is the trash page.
"""

import ctypes
import threading
from typing import Dict

import torch

from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.ops.attention import _repeat_kv

NEG_INF = -1e30
VARIANTS = ("decode", "chunk", "verify")

#: The CUDA kernels of ``csrc/paged_attention.cu``: ``decode`` is
#: ``paged_decode_split_kernel`` (the page walk split across blocks),
#: ``chunk`` is ``paged_chunk_wgmma_kernel`` for bf16 queries of head_dim
#: 64 or 128 (the tensor-core core of ``csrc/attn_fwd_core.cuh``, over
#: bf16 or int8 pools) and ``paged_chunk_kernel`` otherwise (f32,
#: head_dim 32), ``verify`` is ``paged_decode_split_kernel``'s verify
#: instantiation.
KERNELS = ("decode", "chunk", "verify")
#: the kernel ids the C entry point takes
CUDA_KERNEL_IDS = {"paged_decode_split_kernel": 0, "paged_chunk_kernel": 1,
                   "paged_decode_split_kernel<VERIFY>": 2,
                   "paged_chunk_wgmma_kernel": 3}
#: launches of each kernel since the last ``reset_launches()``: a
#: ``decode``/``chunk`` call counts under the kernel its rows pick
#: (``kernel_for``), a ``verify`` call always under ``verify``
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_PAGE_SIZE = 32
_DECODE_KERNEL_MAX_ROWS = 8  # decode calls of more rows are chunk-shaped
_WGMMA_HEAD_DIMS = (64, 128)  # paged_chunk_wgmma_kernel's
# query rows of a row tile (split_rows, kTcRows in
# csrc/paged_attention.cu): decode and verify's paged_decode_split_kernel,
# the chunk's paged_chunk_wgmma_kernel; keys of a split kernel's stage
# (kSplitKeys) and of a chunk kernel's tile (kTcKeys)
SPLIT_ROWS = {"decode": 8, "verify": 32, "chunk": 128}
SPLIT_KEYS = 32
CHUNK_KEYS = 64
# the split planner: blocks an SM it aims for, and the fewest stages of
# keys a split takes (each split's partial state costs a write and a read)
_SPLIT_BLOCKS_PER_SM = 8
_SPLIT_MIN_STAGES = 2
_SPLIT_MAX = 64  # the kernel's merge takes at most 64 splits
# the chunk planner: the fewest key tiles a split takes
_CHUNK_MIN_TILES = 4


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def kernel_for(c: int, h: int, hkv: int, variant: str = "decode") -> str:
    """The kernel a call with ``c`` queries per slot, ``h`` query heads
    and ``hkv`` KV heads launches. ``verify`` has its own; otherwise
    ``decode`` while each (slot, KV head) has at most 8 query rows
    (``c · h / hkv``), else ``chunk``. Either of those computes either
    variant; the variant only sets the plain version's precision."""
    if variant == "verify":
        return "verify"
    return "decode" if c * (h // hkv) <= _DECODE_KERNEL_MAX_ROWS else "chunk"


def cuda_kernel(kernel: str, dtype, head_dim: int) -> str:
    """The CUDA kernel that runs ``kernel`` (``kernel_for``'s answer) for
    queries of ``dtype`` and ``head_dim``: a bf16 chunk of head_dim 64 or
    128 runs on the tensor cores (``paged_chunk_wgmma_kernel``), whatever
    the pools (bf16 or int8); f32 and head_dim 32 keep
    ``paged_chunk_kernel``."""
    if kernel == "decode":
        return "paged_decode_split_kernel"
    if kernel == "verify":
        return "paged_decode_split_kernel<VERIFY>"
    if dtype == torch.bfloat16 and head_dim in _WGMMA_HEAD_DIMS:
        return "paged_chunk_wgmma_kernel"
    return "paged_chunk_kernel"


def plan_splits(b: int, hkv: int, row_tiles: int, w: int, ps: int,
                n_sm: int) -> int:
    """How many blocks share each row tile's page walk in
    ``paged_decode_split_kernel``: about eight blocks an SM over the
    ``b · hkv · row_tiles`` row tiles, each split at least two stages of
    keys (``SPLIT_KEYS`` each) and one table column, 64 at most. It reads
    only the launch shape, never positions or tables, so it needs no
    device read and the same call always splits the same way. Returns S
    with 1 <= S <= max(w, 1)."""
    if w <= 1:
        return 1
    want = -(-_SPLIT_BLOCKS_PER_SM * n_sm // (b * hkv * row_tiles))
    most = max(1, w * ps // (_SPLIT_MIN_STAGES * SPLIT_KEYS))
    return max(1, min(want, most, w, _SPLIT_MAX))


def plan_chunk_splits(b: int, hkv: int, row_tiles: int, w: int, ps: int,
                      n_sm: int) -> int:
    """How many blocks share each row tile's page walk in
    ``paged_chunk_wgmma_kernel``. A block of that kernel takes a whole SM
    (its registers), so blocks beyond the SM count wait for a second wave
    and the walk is only as short as a wave allows: the splits fill one
    wave, ``S = n_sm // (b · hkv · row_tiles)`` (fewer SMs idle than
    there are row tiles), each split at least ``_CHUNK_MIN_TILES``
    tiles of ``CHUNK_KEYS`` keys and one table column, 64 at most. Like
    ``plan_splits`` it reads only the launch shape, so the same call
    always splits the same way. Returns S with 1 <= S <= max(w, 1)."""
    if w <= 1:
        return 1
    fill = n_sm // (b * hkv * row_tiles)
    most = max(1, w * ps // (_CHUNK_MIN_TILES * CHUNK_KEYS))
    return max(1, min(fill, most, w, _SPLIT_MAX))


def call_splits(kernel: str, cuda: str, b: int, c: int, h: int, hkv: int,
                w: int, ps: int, n_sm: int) -> int:
    """The split count a call launches with: ``kernel`` is
    ``kernel_for``'s answer, ``cuda`` ``cuda_kernel``'s. The split kernels
    (decode, verify) plan by ``plan_splits``, the tensor-core chunk kernel
    by ``plan_chunk_splits``, over the row tiles of ``SPLIT_ROWS`` rows;
    the CUDA-core chunk kernel never splits."""
    if cuda == "paged_chunk_kernel":
        return 1
    tiles = -(-c * (h // hkv) // SPLIT_ROWS[kernel])
    plan = plan_chunk_splits if kernel == "chunk" else plan_splits
    return plan(b, hkv, tiles, w, ps, n_sm)


def chunk_split_keys(lo: int, hi: int, window: int, w: int, ps: int,
                     splits: int):
    """The keys ``[kbeg, kend]`` each split of ``paged_chunk_wgmma_kernel``
    walks for a row tile whose positions span ``[lo, hi]``, in split order
    (empty: ``kend < kbeg``). The keys some row may see, ``[lo - window +
    1, hi]`` cut to the table's ``w · ps``, are T tiles of ``CHUNK_KEYS``
    from the first; split s takes tiles ``[s·T // S, (s+1)·T // S)``."""
    k_lo = max(0, lo - window + 1) if window else 0
    k_hi = min(hi, w * ps - 1)
    n_all = (k_hi - k_lo) // CHUNK_KEYS + 1 if k_hi >= k_lo else 0
    keys = []
    for s in range(splits):
        t0, t1 = s * n_all // splits, (s + 1) * n_all // splits
        kbeg = k_lo + t0 * CHUNK_KEYS
        keys.append((kbeg, min(k_hi, kbeg + (t1 - t0) * CHUNK_KEYS - 1)))
    return keys


def split_columns(w: int, splits: int):
    """The table columns ``[c0, c1)`` each split walks, in split order:
    split s takes ``[s·w // S, (s+1)·w // S)``, as the kernel does."""
    return [(s * w // splits, (s + 1) * w // splits) for s in range(splits)]


# ---------------------------------------------------------------------------
# Page-level helpers shared by the reference, the kernel and the decoder
# ---------------------------------------------------------------------------


def _pool_info(pools, kv_heads):
    """(mode, page_size, kv_heads, head_dim) from a per-layer pool dict.

    bf16 pools carry the head split in their shape; int8 pools store
    flat quant blocks, so ``kv_heads`` must come from the caller."""
    if "k" in pools:
        _, ps, hkv, d = pools["k"].shape
        return "bf16", ps, hkv, d
    if kv_heads is None:
        raise ValueError(
            "int8 pools store flat quant blocks; pass kv_heads= so the "
            "row can be split back into heads"
        )
    _, ps, nb, blk = pools["k_q"].shape
    row = nb * blk
    if row % kv_heads:
        raise ValueError(f"row of {row} elems not divisible by "
                         f"kv_heads={kv_heads}")
    return "int8", ps, kv_heads, row // kv_heads


def gather_pages(pools, block_tables, *, kv_heads=None, max_pages=None,
                 dtype=None):
    """K/V for ONLY the pages the block table names → ``(k, v)`` each
    ``[B, W·ps, Hkv, D]``, ``W`` = ``max_pages`` or the table width.
    Unassigned entries (-1) clamp onto the trash page — finite garbage
    the caller masks by position. int8 payloads dequantize to ``dtype``
    (default bf16)."""
    tables = block_tables if max_pages is None else block_tables[:, :max_pages]
    t = tables.clamp(min=0).long()
    mode, ps, hkv, d = _pool_info(pools, kv_heads)
    b, w = t.shape
    if mode == "bf16":
        k, v = pools["k"][t], pools["v"][t]
    else:
        dt = dtype if dtype is not None else torch.bfloat16
        k = quant.kv_decode_rows(pools["k_q"][t], pools["k_scale"][t], dt)
        v = quant.kv_decode_rows(pools["v_q"][t], pools["v_scale"][t], dt)
    shape = (b, w * ps, hkv, d)
    return k.reshape(shape), v.reshape(shape)


def write_page_rows(pools, block_tables, positions, valid, k_rows, v_rows):
    """Commit token K/V rows into their page cells, IN PLACE.

    phys = table[position // ps], offset = position % ps; invalid lanes
    write trash cell (0, 0), where duplicate writes are harmless
    garbage. int8 pools encode on write. ``positions``/``valid`` are
    ``[B, C]``; rows ``[B, C, Hkv, D]``. The JAX twin returns new pools
    (its engine donates the buffers); the port updates the given
    tensors (views into the layer-leading pools) and returns the dict.
    """
    mode, ps, _, _ = _pool_info(pools, k_rows.shape[2])
    # torch.gather raises on an index past the table where
    # jnp.take_along_axis clamps: clamp first (such lanes are invalid)
    page_idx = (positions // ps).clamp(0, block_tables.shape[1] - 1)
    offs = positions % ps
    phys = torch.gather(block_tables, 1, page_idx.to(block_tables.dtype))
    phys = torch.where(valid, phys.clamp(min=0), 0).long()  # 0 == TRASH
    offs = torch.where(valid, offs, 0).long()
    if mode == "bf16":
        dt = pools["k"].dtype
        pools["k"][phys, offs] = k_rows.to(dt)
        pools["v"][phys, offs] = v_rows.to(dt)
        return pools
    blk = pools["k_q"].shape[-1]
    b, c, hkv, d = k_rows.shape
    kq, ks = quant.kv_encode_rows(k_rows.reshape(b, c, hkv * d), blk)
    vq, vs = quant.kv_encode_rows(v_rows.reshape(b, c, hkv * d), blk)
    pools["k_q"][phys, offs] = kq
    pools["k_scale"][phys, offs] = ks
    pools["v_q"][phys, offs] = vq
    pools["v_scale"][phys, offs] = vs
    return pools


def _query_positions(positions, b, c, device):
    """Positions as int32 ``[B, C]`` (decode takes ``[B]`` or a scalar)."""
    pos = torch.as_tensor(positions, device=device).to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(b)
    if pos.ndim == 1:
        pos = pos[:, None]
    if tuple(pos.shape) != (b, c):
        raise ValueError(
            f"positions {tuple(pos.shape)} must broadcast to queries {(b, c)}"
        )
    return pos.contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the kernel's oracle)
# ---------------------------------------------------------------------------


def paged_attention_reference(
    q,                  # [B, C, H, D] (decode: C == 1)
    pools,              # per-LAYER pool slices (bf16 or int8 keys)
    block_tables,       # [B, max_pages] int32, -1 = unassigned
    positions,          # decode: [B] (or scalar); chunk/verify: [B, C]
    *,
    scale,
    window: int = 0,
    kv_heads=None,
    max_pages=None,
    variant: str = "decode",
    extra_k=None,       # verify: in-flight chunk K rows [B, C, Hkv, D]
    extra_v=None,
):
    """Paged attention via a pages-held-only gather + the dense cached
    attention, op for op the JAX ``paged_attention_reference``. Output
    ``[B, C, H, D]`` in ``q.dtype``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    b, c, h, d = q.shape
    k, v = gather_pages(pools, block_tables, kv_heads=kv_heads,
                        max_pages=max_pages, dtype=q.dtype)
    s_len, hkv = k.shape[1], k.shape[2]
    kpos = torch.arange(s_len, device=q.device)
    pos = torch.as_tensor(positions, device=q.device)
    if variant == "verify":
        if extra_k is None or extra_v is None:
            raise ValueError("verify variant needs extra_k/extra_v rows")
        if pos.ndim != 2:
            raise ValueError("verify variant needs per-query positions [B, C]")
        start = pos[:, 0]
        groups = h // hkv
        qg = q.reshape(b, c, hkv, groups, d)
        kf = torch.cat([k.float(), extra_k.float()], dim=1)
        vf = torch.cat([v.float(), extra_v.float()], dim=1)
        # key positions: committed rows at their cell index, in-flight
        # rows at the chunk positions
        key_pos = torch.cat([kpos.expand(b, s_len), pos], dim=1)
        committed = torch.cat(
            [torch.ones((b, s_len), dtype=torch.bool, device=q.device),
             torch.zeros((b, c), dtype=torch.bool, device=q.device)], dim=1)
        mask = key_pos[:, None, :] <= pos[:, :, None]
        mask = mask & (~committed | (key_pos < start[:, None]))[:, None, :]
        if window:
            mask = mask & (key_pos[:, None, :] > pos[:, :, None] - window)
        s = torch.einsum("bckgd,bskd->bckgs", qg.float(), kf) * scale
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bckgs,bskd->bckgd", p, vf)
        return out.reshape(b, c, h, d).to(q.dtype)
    if variant == "decode":
        if c != 1:
            raise ValueError("decode variant takes a single query (C=1)")
        groups = h // hkv
        qg = q.reshape(b, hkv, groups, d)
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
        if pos.ndim == 0:
            mask = kpos <= pos
            if window:
                mask = mask & (kpos > pos - window)
            mask = mask[None, None, None, :]
        else:
            mask = kpos[None, :] <= pos[:, None]
            if window:
                mask = mask & (kpos[None, :] > pos[:, None] - window)
            mask = mask[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
        return out.reshape(b, 1, h, d).to(q.dtype)
    if pos.ndim != 2:
        raise ValueError("chunk variant needs per-query positions [B, C]")
    if hkv != h:
        k = _repeat_kv(k, h // hkv)
        v = _repeat_kv(v, h // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = kpos[None, None, :] <= pos[:, :, None]
    if window:
        mask = mask & (kpos[None, None, :] > pos[:, :, None] - window)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_lib_fn = None
_sms: Dict[int, int] = {}
# the split kernel's workspace, per device: f32 partials, the row tiles'
# counters (zero between calls) and the stream its calls run on
_workspaces: Dict[str, Dict] = {}
# serializes workspace growth, launches and LAUNCHES across serve loops
_launch_lock = threading.Lock()


def _kernel():
    """The C entry point of ``csrc/paged_attention.cu``, built on first
    use, with its argument types declared."""
    global _lib_fn
    if _lib_fn is None:
        from dlrover_tpu_torch.ops import _build

        fn = _build.load("paged_attention").dlrover_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 10 + [i] * 10 + [ctypes.c_float] + [i] * 3
                       + [p] * 3 + [i])
        fn.restype = i
        _lib_fn = fn
    return _lib_fn


def _sm_count(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _workspace(dev, stream, n_floats: int, n_tiles: int):
    """The split kernel's persistent workspace on ``dev``, grown on
    demand: ``n_floats`` f32 partials and ``n_tiles`` int32 counters, zero
    at allocation (each call leaves them zero). Calls on one device share
    it, so they must run in order: on ``stream``, the stream of its first
    call (a graph capture, which only records, excepted). Call under
    ``_launch_lock``."""
    handle = stream.cuda_stream
    ws = _workspaces.setdefault(str(dev), {"stream": handle})
    if ws["stream"] != handle and not torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"paged_attention on {dev}: a call on stream {handle:#x} while "
            f"the split workspace belongs to stream {ws['stream']:#x}; calls "
            "that share it must run in order on one stream")
    if "part" not in ws or ws["part"].numel() < n_floats:
        ws["part"] = torch.empty(n_floats, dtype=torch.float32, device=dev)
    if "counters" not in ws or ws["counters"].numel() < n_tiles:
        ws["counters"] = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    return ws["part"], ws["counters"]


def _check(t, name, device, dtype=None, shape=None, align=16):
    """Raise unless ``t`` is what the kernel reads: on ``device``, of
    ``dtype`` and ``shape``, contiguous, and ``align``-byte aligned (16
    for the rows it loads as 16-byte vectors; 4 for the block tables,
    read one int at a time, whose one-slot slices start mid-row)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _paged_call(q, pools, block_tables, positions, *, scale, window,
                kv_heads, max_pages, variant, extra_k=None, extra_v=None):
    """Launch the CUDA kernel on ``q``'s device and current stream."""
    mode, ps, hkv, d = _pool_info(pools, kv_heads)
    b, c, h, qd = q.shape
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention kernel takes f32/bf16 q, got {q.dtype}")
    if qd != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"(Hkv={hkv}, D={d})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if ps > _MAX_PAGE_SIZE:
        raise ValueError(f"paged_attention kernel takes page_size <= "
                         f"{_MAX_PAGE_SIZE}, got {ps}")
    if variant == "decode" and c != 1:
        raise ValueError("decode variant takes a single query (C=1)")
    _check(q, "q", dev)
    tables = block_tables
    _check(tables, "block_tables", dev, torch.int32, align=4)
    w_full = tables.shape[1]
    w = w_full if max_pages is None else min(int(max_pages), w_full)
    pos = _query_positions(positions, b, c, dev)
    ek_ptr = ev_ptr = None
    if variant == "verify":
        if extra_k is None or extra_v is None:
            raise ValueError("verify variant needs extra_k/extra_v rows")
        for name, t in (("extra_k", extra_k), ("extra_v", extra_v)):
            _check(t, name, dev, q.dtype, (b, c, hkv, d))
        ek_ptr, ev_ptr = extra_k.data_ptr(), extra_v.data_ptr()
    out = torch.empty_like(q)
    if w == 0 and variant != "verify":
        return out.zero_()
    n_pages = None
    if mode == "bf16":
        n_pages = pools["k"].shape[0]
        for name in ("k", "v"):
            _check(pools[name], name, dev, q.dtype, (n_pages, ps, hkv, d))
        k_ptr, v_ptr = pools["k"].data_ptr(), pools["v"].data_ptr()
        ks_ptr = vs_ptr = None
        blk = 1
    else:
        n_pages, _, nb, blk = pools["k_q"].shape
        if blk % 4:
            raise ValueError(f"paged_attention kernel takes int8 blocks "
                             f"of a multiple of 4 elements, got {blk}")
        for name in ("k_q", "v_q"):
            _check(pools[name], name, dev, torch.int8, (n_pages, ps, nb, blk))
        for name in ("k_scale", "v_scale"):
            _check(pools[name], name, dev, torch.float32, (n_pages, ps, nb))
        k_ptr, v_ptr = pools["k_q"].data_ptr(), pools["v_q"].data_ptr()
        ks_ptr = pools["k_scale"].data_ptr()
        vs_ptr = pools["v_scale"].data_ptr()
    kernel = kernel_for(c, h, hkv, variant)
    cuda = cuda_kernel(kernel, q.dtype, d)
    stream = torch.cuda.current_stream(dev)
    part_ptr, cnt_ptr = None, None
    splits = call_splits(kernel, cuda, b, c, h, hkv, w, ps, _sm_count(dev))
    fn = _kernel()
    with _launch_lock:
        if splits > 1:
            rows = SPLIT_ROWS[kernel]
            n_tiles = b * hkv * -(-c * (h // hkv) // rows)
            part, counters = _workspace(
                dev, stream, n_tiles * splits * rows * (d + 2), n_tiles)
            part_ptr, cnt_ptr = part.data_ptr(), counters.data_ptr()
        err = fn(
            q.data_ptr(), out.data_ptr(), k_ptr, v_ptr, ks_ptr, vs_ptr,
            tables.data_ptr(), pos.data_ptr(), ek_ptr, ev_ptr,
            b, c, h, hkv, d, ps, w, w_full, blk, int(window), float(scale),
            _DTYPE_CODE[q.dtype], int(mode == "int8"), CUDA_KERNEL_IDS[cuda],
            stream.cuda_stream,
            part_ptr, cnt_ptr, splits,
        )
        if err != 0:
            raise RuntimeError(
                f"paged_attention kernel launch failed: cudaError {err}"
            )
        LAUNCHES[kernel] += 1
    return out


def paged_attention(
    q,
    pools,
    block_tables,
    positions,
    *,
    scale,
    window: int = 0,
    kv_heads=None,
    max_pages=None,
    variant: str = "decode",
    extra_k=None,
    extra_v=None,
):
    """Paged attention over block-table KV pools.

    A CUDA ``q`` launches the Hopper kernel (f32 online softmax, matches
    the plain version to float tolerance); a CPU ``q`` runs
    ``paged_attention_reference``. ``max_pages`` bounds the walk to the
    first table columns (the host knows how many pages slots hold).
    ``positions``: ``[B]`` for decode, ``[B, C]`` for chunk and verify;
    ``verify`` also takes the in-flight ``extra_k``/``extra_v`` rows
    ``[B, C, Hkv, D]``, folded as keys without touching the pools."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    kw = dict(scale=scale, window=window, kv_heads=kv_heads,
              max_pages=max_pages, variant=variant, extra_k=extra_k,
              extra_v=extra_v)
    if q.device.type == "cpu":
        return paged_attention_reference(q, pools, block_tables, positions,
                                         **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    return _paged_call(q, pools, block_tables, positions, **kw)
