"""The flash kernels' ring offsets: the port against the JAX package.

Ring attention hands a block's global positions ``(q_off, k_off)`` to
the flash kernels in two of its block cases: a window-partial block (the
window edge crosses it) and a prefix-only block (``(-(1 << 30), 0)``: the
causal term dead, only the block's keys inside the prefix seen). The
JAX side is ``flash_attention_with_lse(q, k, v, prefix, offs, ...)`` in
Pallas interpret mode (``INTERPRET`` and ``_on_tpu`` patched, as
``tests/test_sequence_parallel.py`` runs its flash ring), forward and,
through ``jax.vjp``, its Pallas backward with an lse cotangent; the
port's side is ``flash_attention_with_lse`` on CPU tensors (its plain
versions, through the same autograd function the card uses). Inputs come
from numpy with a seed.

A row that sees no key of the block leaves the JAX kernel with an lse of
exactly -1e30 and an output the ring merge never reads; the port's
router returns ``(0, NEG_INF)`` there. So the outputs are compared on
the rows that see a key, both lses must be at or below NEG_INF on the
others, and the cotangents are zero on those rows (the ring merge gives
them no gradient).

Tolerances, f32: the forward 2e-5 (the same sums in another order), the
gradients 1e-4 (``test_torch_flash_attention.py``'s), tighter than the
JAX ring test's 3e-3 / 5e-3, which it sets for bf16-free interpret runs
of a whole ring.

The plain twins of the kernels' tile and range math (``key_tiles``,
``q_tiles``, ``dkv_q_range``) are held against a brute-force mask
(``_allowed``) at offsets that include -(1 << 30): every visible pair
lies in a visited tile, and the floor division leaves a prefix-less
prefix-only walk empty (C's truncation would visit tile 0).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops import pallas_attention as jpa  # noqa: E402
from dlrover_tpu_torch.ops import flash_attention as fa  # noqa: E402
from dlrover_tpu_torch.ops.attention import NEG_INF  # noqa: E402

NEG = -(1 << 30)

# (name, B, S, H, Hkv, D, window, (q_off, k_off), prefix)
_CASES = [
    # a window-boundary block, GQA, at D 128 and D 64: the rows from 199
    # (D 128) and 149 (D 64) on see no key of the block
    ("window_d128", 1, 256, 4, 2, 128, 200, (512, 256), None),
    ("window_d64", 2, 256, 4, 2, 64, 150, (512, 256), None),
    # a prefix-only block, MHA at D 64 (packed two heads a kernel block
    # on the card): prefix 0 (no row sees a key), inside, past the block
    ("prefix_only_packed", 3, 256, 4, 4, 64, 0, (NEG, 0), (0, 100, 256)),
]


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            rng.standard_normal((b, s, hkv, d), dtype=np.float32),
            rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, h, s), dtype=np.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name,b,s,h,hkv,d,window,offsets,prefix", _CASES)
def test_offsets_match_the_jax_kernels(monkeypatch, name, b, s, h, hkv, d,
                                       window, offsets, prefix):
    if jpa.pltpu is None:
        pytest.skip("pallas TPU module unavailable")
    monkeypatch.setattr(jpa, "INTERPRET", True)
    monkeypatch.setattr(jpa, "_on_tpu", lambda: True)
    q, k, v, g, g_lse = _inputs(sum(map(ord, name)), b, s, h, hkv, d)
    scale = d ** -0.5
    pref_t = None if prefix is None else torch.tensor(prefix)
    seen = fa._allowed(s, s, True, window, pref_t, offsets,
                       "cpu").any(-1).expand(b, s).numpy()   # [B, S]
    assert seen.any() and not seen.all()
    g = np.where(seen[:, :, None, None], g, 0.0).astype(np.float32)
    g_lse = np.where(seen[:, None, :], g_lse, 0.0).astype(np.float32)
    pack = fa.head_pack_for(h, hkv, d)

    jprefix = None if prefix is None else jnp.asarray(prefix, jnp.int32)
    joffs = jnp.asarray(offsets, jnp.int32)

    def jfn(q, k, v):
        return jpa.flash_attention_with_lse(
            q, k, v, jprefix, joffs, True, scale, 128, 128, window, pack)

    (jout, jlse), vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp((jnp.asarray(g), jnp.asarray(g_lse)))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(
        *leaves, causal=True, softmax_scale=scale, window=window,
        prefix_len=pref_t, offsets=offsets)
    ((out * torch.from_numpy(g)).sum()
     + (lse * torch.from_numpy(g_lse)).sum()).backward()

    rows = seen  # [B, S]
    _close(out.detach().numpy()[rows], np.asarray(jout)[rows], 2e-5)
    lse_n, jlse_n = lse.detach().numpy(), np.asarray(jlse)
    lse_rows = np.transpose(lse_n, (0, 2, 1))
    jlse_rows = np.transpose(jlse_n, (0, 2, 1))
    _close(lse_rows[rows], jlse_rows[rows], 2e-5)
    assert (lse_rows[~rows] <= NEG_INF).all()
    assert (jlse_rows[~rows] <= NEG_INF).all()
    for port, ref in zip(leaves, jgrads):
        _close(port.grad.numpy(), ref, 1e-4)


# ---------------------------------------------------------------------------
# the plain twins of the kernels' tile and range math
# ---------------------------------------------------------------------------

# (sq, sk, window, offsets, prefix)
_GEOMETRY = [
    (256, 256, 0, (0, 0), None),
    (200, 256, 0, (512, 256), None),          # a dense block
    (256, 256, 200, (512, 256), None),        # window-partial
    (300, 300, 333, (900, 600), None),        # ragged tiles
    (256, 200, 100, (1000, 0), None),         # past every window: empty
    (256, 256, 0, (NEG, 0), (0, 100, 256)),   # prefix-only
    (128, 192, 0, (NEG, 0), (0, 0)),          # prefix-only, no reach
    (256, 256, 0, (NEG + 256, 256), (300, 600)),  # prefix-only, k_off > 0
    (256, 256, 0, (256, 256), (300, 10)),     # the diagonal with a prefix
]


def _brute(sq, sk, window, offsets, prefix):
    pref = None if prefix is None else torch.tensor(prefix)
    m = fa._allowed(sq, sk, True, window, pref, offsets, "cpu")
    return m.expand(1 if prefix is None else len(prefix), sq, sk)


@pytest.mark.parametrize("sq,sk,window,offsets,prefix", _GEOMETRY)
def test_tile_and_range_twins_cover_every_visible_pair(sq, sk, window,
                                                       offsets, prefix):
    mask = _brute(sq, sk, window, offsets, prefix)
    pref = prefix if prefix is not None else [0]
    lo, hi = fa.dkv_q_range(
        sq, sk, True, window,
        None if prefix is None else torch.tensor(prefix), offsets)
    q_idx = torch.arange(sq)[None, :, None]
    # the dkv kernels' per-key query range is exactly the mask
    ranged = (q_idx >= lo[:, None, :]) & (q_idx < hi[:, None, :])
    assert torch.equal(ranged.expand_as(mask), mask)
    for bi, p in enumerate(pref):
        lp = fa.local_prefix(p, offsets[1], sk) if prefix is not None else 0
        m = mask[bi]
        # forward and dq: q tiles of 128 (bf16 forward; 64 the others)
        # over key tiles of 128, 64
        for bq, bk in ((128, fa.FWD_TILE_KEYS), (64, fa.DQ_TILE_KEYS),
                       (64, 64)):
            for q0 in range(0, sq, bq):
                b, e = fa.key_tiles(q0, bq, bk, sk, True, window, lp,
                                    offsets)
                keys = m[q0:q0 + bq].any(0).nonzero()[:, 0]
                assert all(b <= int(kk) // bk < e for kk in keys), (q0, b, e)
        # dkv: key tiles of 128 (bf16) and 64 (f32) over q tiles of 64
        # (bf16) and 32 (f32)
        for keys_per, rows in ((128, fa.DKV_TILE_ROWS), (64, 32)):
            for k0 in range(0, sk, keys_per):
                b, e = fa.q_tiles(k0, keys_per, sq, True, window, lp,
                                  offsets, rows)
                qs = m[:, k0:k0 + keys_per].any(1).nonzero()[:, 0]
                assert all(b <= int(qq) // rows < e for qq in qs), (k0, b, e)


def test_a_dark_prefix_only_walk_visits_no_tile():
    """The floor division at a negative position: with q_off = -2^30 and
    no prefix reaching the block, every walk is empty (a truncating
    division would put the last tile at 0 and visit tile 0)."""
    for q0 in (0, 64, 128):
        assert fa.key_tiles(q0, 64, 64, 256, True, 0, 0, (NEG, 0)) == (0, 0)
    for k0 in (0, 64):
        b, e = fa.q_tiles(k0, 64, 256, True, 0, 0, (NEG, 0))
        assert b >= e
    # and the prefix's tiles are exactly the ones visited
    assert fa.key_tiles(0, 64, 64, 256, True, 0, 100, (NEG, 0)) == (0, 2)


def test_offsets_out_of_the_kernels_range_raise():
    with pytest.raises(ValueError, match="int32 range"):
        fa.host_offsets((NEG, 1 << 30))
    with pytest.raises(ValueError, match="int32 range"):
        fa.host_offsets((0, 0), sq=1 << 24)
    assert fa.host_offsets(torch.tensor([NEG, 0])) == (NEG, 0)
