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
  ``mha_reference``). The kernel keeps f32 throughout in both variants,
  so it matches the plain version to a tolerance, not bitwise.
- ``write_page_rows`` / ``gather_pages`` — the page-level tensor ops the
  decoder and the reference share.

The ``verify`` variant (speculative decoding) is not ported yet.

Pools are one layer's slices: bf16 (or f32) ``{"k", "v"}`` of
``[n_pages, ps, Hkv, D]``, or int8 ``{"k_q", "k_scale", "v_q",
"v_scale"}`` of ``[n_pages, ps, nb, blk]`` payloads and
``[n_pages, ps, nb]`` f32 scales. Page 0 is the trash page.
"""

import ctypes
from typing import Dict

import torch

from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.ops.attention import _repeat_kv

NEG_INF = -1e30
VARIANTS = ("decode", "chunk")

#: The CUDA kernels of ``csrc/paged_attention.cu``: ``decode`` is
#: ``paged_decode_kernel``, ``chunk`` is ``paged_chunk_kernel``.
KERNELS = ("decode", "chunk")
#: launches of each kernel since the last ``reset_launches()``, counted
#: by the kernel launched (``kernel_for``), not by the variant asked for
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_PAGE_SIZE = 32
_DECODE_KERNEL_MAX_ROWS = 8  # paged_decode_kernel holds <= 8 rows per warp


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def kernel_for(c: int, h: int, hkv: int) -> str:
    """The kernel a call with ``c`` queries per slot, ``h`` query heads
    and ``hkv`` KV heads launches: ``decode`` while each (slot, KV head)
    has at most 8 query rows (``c · h / hkv``), else ``chunk``. Either
    computes either variant; the variant only sets the plain version's
    precision."""
    return "decode" if c * (h // hkv) <= _DECODE_KERNEL_MAX_ROWS else "chunk"


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
    positions,          # decode: [B] (or scalar); chunk: [B, C]
    *,
    scale,
    window: int = 0,
    kv_heads=None,
    max_pages=None,
    variant: str = "decode",
):
    """Paged attention via a pages-held-only gather + the dense cached
    attention, op for op the JAX ``paged_attention_reference``. Output
    ``[B, C, H, D]`` in ``q.dtype``."""
    if variant not in VARIANTS:
        raise NotImplementedError(
            f"variant {variant!r}: only decode and chunk are ported; the "
            "verify variant waits for speculative decoding (ROADMAP B7)"
        )
    b, c, h, d = q.shape
    k, v = gather_pages(pools, block_tables, kv_heads=kv_heads,
                        max_pages=max_pages, dtype=q.dtype)
    s_len, hkv = k.shape[1], k.shape[2]
    kpos = torch.arange(s_len, device=q.device)
    pos = torch.as_tensor(positions, device=q.device)
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


def _kernel():
    """The C entry point of ``csrc/paged_attention.cu``, built on first
    use, with its argument types declared."""
    global _lib_fn
    if _lib_fn is None:
        from dlrover_tpu_torch.ops import _build

        fn = _build.load("paged_attention").dlrover_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 10 + [ctypes.c_float] + [i] * 3 + [p]
        fn.restype = i
        _lib_fn = fn
    return _lib_fn


def _check(t, name, device, dtype=None, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _paged_call(q, pools, block_tables, positions, *, scale, window,
                kv_heads, max_pages, variant):
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
    _check(tables, "block_tables", dev, torch.int32)
    w_full = tables.shape[1]
    w = w_full if max_pages is None else min(int(max_pages), w_full)
    pos = _query_positions(positions, b, c, dev)
    out = torch.empty_like(q)
    if w == 0:
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
    kernel = kernel_for(c, h, hkv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(
        q.data_ptr(), out.data_ptr(), k_ptr, v_ptr, ks_ptr, vs_ptr,
        tables.data_ptr(), pos.data_ptr(),
        b, c, h, hkv, d, ps, w, w_full, blk, int(window), float(scale),
        _DTYPE_CODE[q.dtype], int(mode == "int8"), KERNELS.index(kernel),
        stream,
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
):
    """Paged attention over block-table KV pools.

    A CUDA ``q`` launches the Hopper kernel (f32 online softmax, matches
    the plain version to float tolerance); a CPU ``q`` runs
    ``paged_attention_reference``. ``max_pages`` bounds the walk to the
    first table columns (the host knows how many pages slots hold).
    ``positions``: ``[B]`` for decode, ``[B, C]`` for chunk."""
    if variant not in VARIANTS:
        raise NotImplementedError(
            f"variant {variant!r}: only decode and chunk are ported; the "
            "verify variant waits for speculative decoding (ROADMAP B7)"
        )
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pools, block_tables, positions, scale=scale, window=window,
            kv_heads=kv_heads, max_pages=max_pages, variant=variant,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    return _paged_call(
        q, pools, block_tables, positions, scale=scale, window=window,
        kv_heads=kv_heads, max_pages=max_pages, variant=variant,
    )
