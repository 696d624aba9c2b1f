"""Token sampling for the serving engine.

Port of ``dlrover_tpu/models/generate.py``'s ``warp_logits`` and
``draw_token``. The warp is the same temperature → top-k → top-p
sequence, row-wise over ``[B, V]`` logits with per-row parameters.

The draw differs from JAX by design: JAX draws
``categorical(fold_in(threefry key, absolute position))``, whose bits
torch cannot reproduce. The port draws by Gumbel-max —
``argmax(warped + g)`` with ``g = -log(-log(u))`` — where ``u`` comes
from a counter-based hash of (request seed, absolute position of the
token being drawn, vocabulary index). The draw therefore depends on
nothing else: not the slot, not the other requests in the batch, not
the device, and a re-prefilled request redraws the same tokens.
Greedy (``temperature == 0``) is a plain argmax.
"""

import torch

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32): split ``c``
    in 16-bit halves so no partial product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (``lowbias32``) over int64 tensors
    holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise ``[B, vocab]`` f32 keyed on each row's
    (seed, position) and the vocabulary index — a pure function of
    those three integers."""
    seeds = seeds.to(torch.int64)
    row = _hash32((seeds & _M32) ^ 0x9E3779B9)
    row = _hash32(row ^ ((seeds >> 32) & _M32))
    row = _hash32(row ^ (positions.to(torch.int64) & _M32))
    idx = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    bits = _hash32(_hash32(row[:, None] ^ idx[None, :]) ^ (row[:, None] >> 7))
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def warp_logits(logits, temperature, top_k=0, top_p=1.0):
    """Temperature → top-k → top-p logit warp, row-wise.

    ``logits`` is ``[B, V]`` float32; ``temperature``/``top_k``/``top_p``
    are scalars or ``[B]`` tensors. Disabled warpers are exact no-ops
    (``top_k=0``, ``top_p>=1``). Masked entries become ``-inf``. The
    caller guarantees ``temperature > 0``."""
    dev = logits.device
    b, v = logits.shape
    t = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    x = logits / t.expand(b)[:, None]
    k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).expand(b)
    srt = torch.sort(x, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, (k.clamp(1, v) - 1)[:, None])
    x = torch.where((k[:, None] > 0) & (x < kth), float("-inf"), x)
    p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(b)
    # nucleus over the top-k-filtered distribution: smallest sorted
    # prefix whose probability mass reaches p (-inf entries sort last
    # and carry zero mass, so they can never be "kept")
    srt = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    n_keep = (exclusive < p[:, None]).sum(-1).clamp(min=1)
    pth = torch.gather(srt, -1, (n_keep - 1)[:, None])
    return torch.where((p[:, None] < 1.0) & (x < pth), float("-inf"), x)


def draw_token(logits, seeds, positions, temperature, top_k=0, top_p=1.0):
    """One token per row of ``logits`` ``[B, V]`` f32 → int32 ``[B]``.

    ``seeds``/``positions`` (``[B]`` int) key the Gumbel noise: the
    position is the absolute position of the token being drawn. Rows
    with ``temperature == 0`` take the argmax; greedy and sampled rows
    mix freely in one call."""
    b, v = logits.shape
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).expand(b)
    greedy = torch.argmax(logits, dim=-1)
    sampled_rows = t > 0
    if not bool(sampled_rows.any()):
        return greedy.to(torch.int32)
    warped = warp_logits(logits, torch.where(sampled_rows, t, 1.0),
                         top_k, top_p)
    noise = gumbel_noise(seeds, positions, v)
    sampled = torch.argmax(warped + noise, dim=-1)
    return torch.where(sampled_rows, sampled, greedy).to(torch.int32)
