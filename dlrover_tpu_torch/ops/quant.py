"""The int8 KV block codec of the paged serving cache.

Port of the KV part of ``dlrover_tpu/ops/quant.py``: ``_quant_blocks`` /
``_dequant_blocks`` (8-bit only), ``kv_block_size``, ``kv_encode_rows``
and ``kv_decode_rows``. The encoding is the per-block max/127 scheme:
one f32 scale per block of ``block`` elements, payloads rounded half to
even (``torch.round``, like ``jnp.round``) and clipped to ±127. Every
step is the same f32 operation in the same order as the JAX codec, so
the two are bit-exact (pinned by ``tests/test_torch_quant.py``); the
paged-attention kernel's in-register dequant reproduces
``kv_decode_rows`` on the card.
"""

import torch

BLOCK = 256


def _quant_blocks(blocks: torch.Tensor):
    """Quantize ``(..., block)`` float32 blocks → (int8, f32 scale
    ``(..., 1)``)."""
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def _dequant_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_quant_blocks``: int8 blocks → float32."""
    return q.to(torch.float32) * scale


def kv_block_size(row_elems: int) -> int:
    """Scale-block width for one KV token row of ``row_elems`` floats:
    the whole row when it fits in ``BLOCK``, else the largest divisor of
    the row that does (uniform blocks, no ragged tail). llama3-8b's
    1024-element row (8 KV heads × 128) gets blocks of 256, so one scale
    covers two heads; a row of 3 × 96 gets 96, one head per block."""
    if row_elems <= 0:
        raise ValueError(f"row_elems must be positive, got {row_elems}")
    if row_elems <= BLOCK:
        return row_elems
    for cand in range(BLOCK, 0, -1):
        if row_elems % cand == 0:
            return cand
    return 1


def kv_encode_rows(rows: torch.Tensor, block: int):
    """Encode KV token rows ``[..., n]`` (n % block == 0) → int8 blocks.

    Returns ``(q [..., n//block, block] int8, scale [..., n//block] f32)``.
    """
    *lead, n = rows.shape
    if n % block:
        raise ValueError(f"row width {n} not a multiple of block {block}")
    blocks = rows.to(torch.float32).reshape(*lead, n // block, block)
    q, scale = _quant_blocks(blocks)
    return q, scale[..., 0]


def kv_decode_rows(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of ``kv_encode_rows``: ``[..., nb, block]`` → ``[..., n]``,
    dequantized in f32 then cast to ``dtype`` (the compute dtype)."""
    out = _dequant_blocks(q, scale[..., None])
    *lead, nb, blk = out.shape
    return out.reshape(*lead, nb * blk).to(dtype)
