"""The split page walk of the tensor-core chunk kernel, held on the CPU
against the port's plain version and the JAX package.

``paged_chunk_wgmma_kernel`` (``csrc/paged_attention.cu``) splits each
row tile's walk (128 query rows of one slot and KV head) into S blocks:
the keys the tile's rows may see, ``[min_pos - window + 1, max_pos]``
cut to the table, are T tiles of 64 keys, and split s walks tiles
``[s·T // S, (s+1)·T // S)`` (``chunk_split_keys``). It masks each score
by its row's key range ``[pos - window + 1, pos]`` ANDed with the tile's
mask of keys on assigned pages (``ChunkMask``); the last block to finish
merges the partial ``(m, l, acc)`` states in split order. Here:

- ``_split_chunk`` below, a plain PyTorch split-and-merge of the chunk
  attention (test-only: no path of the port calls it; the kernel's merge
  formula: ``m = max m_s``, ``f_s = exp(m_s - m)``, ``l = sum l_s f_s``,
  ``acc = sum acc_s f_s``, ``out = acc / l`` with ``l == 0 -> 1``; keys on
  unassigned pages never read), equals ``paged_attention_reference`` and
  the JAX package's chunk (its Pallas ``_paged_kernel`` run in interpret
  mode, as the JAX package's own tests run it on the CPU) for every S,
  over bf16 and int8 pools, windows 0 and 300, pages of 8 and 16,
  shuffled tables with -1 tails, a free slot (exact zeros from the
  kernel's rule) and a ragged chunk (37 rows). Tolerance, f32: rtol 1e-5
  / atol 1e-6 against the plain version (the same values summed in
  another grouping), 1e-4 against the interpreted kernel (its online
  softmax reassociates the sums; the JAX package's own bound).
- ``_kernel_mask`` below, the kernel's walk and mask transliterated
  (every split's tiles, their key masks, the row ranges), equals the JAX
  ``_paged_kernel`` rule element by element (booleans): its page test
  (assigned, at or before the chunk's last position, overlapping the
  window) and its key test (``kpos <= pos``, ``kpos > pos - window``),
  with holes in the tables; and no key reaches a row twice. The JAX
  kernel itself, run in interpret mode on one-hot values, shows the same
  mask.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.ops import paged_attention as pa  # noqa: E402
from dlrover_tpu_torch.ops import quant  # noqa: E402
from dlrover_tpu_torch.serving import kv_cache as kvc  # noqa: E402

NEG_INF = -1e30
_TOL = dict(rtol=1e-5, atol=1e-6)


def _jpp():
    """The JAX module holding the Pallas paged kernel, imported where a
    test calls it (as tests/test_torch_paged_attention.py does)."""
    from dlrover_tpu.ops import pallas_paged

    return pallas_paged
_KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
_C = 37                    # a ragged chunk: 74 rows of a 128-row tile
_STARTS = (310, 0, 0)      # slot 1 free
_HKV, _GROUPS, _D = 2, 2, 64


def _setup(mode, ps, seed=0):
    """Three slots of a chunk of _C rows at _STARTS over pools filled from
    numpy rows: slots 0 and 2 on shuffled pages with -1 columns after the
    last one held, slot 1 free (no page). Returns the torch layer pools,
    the same pools as JAX arrays, the tables, positions and f32 queries."""
    cfg = get_config("tiny", n_layer=1, d_model=_HKV * _GROUPS * _D,
                     n_head=_HKV * _GROUPS, n_kv_head=_HKV, dtype="float32")
    geom = kvc.make_geometry(cfg, n_slots=3, max_len=384, page_size=ps,
                             mode=mode)
    rng = np.random.default_rng(seed + ps)
    pools = kvc.init_pools(geom, "cpu")
    for name in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal(
            (1, geom.n_pages, ps, geom.row_elems)).astype(np.float32))
        if mode == "bf16":
            pools[name].copy_(x.reshape(pools[name].shape))
        else:
            q8, sc = quant.kv_encode_rows(x, geom.kv_block)
            pools[name + "_q"].copy_(q8)
            pools[name + "_scale"].copy_(sc)
    layer = kvc.layer_pools(pools, 0)
    perm = list(rng.permutation(np.arange(1, geom.n_pages)))
    tab = np.full((3, geom.max_pages_per_slot), -1, np.int32)
    for i, s in enumerate(_STARTS):
        if i == 1:
            continue
        for j in range(-(-(s + _C) // ps)):
            tab[i, j] = perm.pop()
    pos = (np.asarray(_STARTS)[:, None] + np.arange(_C)).astype(np.int32)
    q = rng.standard_normal((3, _C, _HKV * _GROUPS, _D)).astype(np.float32)
    jpools = {n: jnp.asarray(t.numpy()) for n, t in layer.items()}
    return layer, jpools, tab, pos, q


def _split_chunk(q, pools, tables, positions, *, splits, scale, window):
    """The kernel's split-and-merge on the plain version's arithmetic (f32,
    p not rounded): per (slot, KV head, row tile of 128 (c, g) rows) and
    split s, the held keys ``chunk_split_keys(...)[s]`` give a partial
    (m, l, acc); the partials merge in split order."""
    b, c, h, d = q.shape
    k, v = pa.gather_pages(pools, tables, kv_heads=_HKV,
                           dtype=torch.float32)
    w = tables.shape[1]
    ps = k.shape[1] // w
    kpos = torch.arange(w * ps)
    held = (tables >= 0).long().repeat_interleave(ps, dim=1).bool()
    out = torch.zeros((b, c, h, d))
    rows = [(ci, g) for ci in range(c) for g in range(_GROUPS)]
    for bi in range(b):
        for kh in range(_HKV):
            for r0 in range(0, len(rows), 128):
                cs = torch.as_tensor([ci for ci, _ in rows[r0:r0 + 128]])
                hs = torch.as_tensor([kh * _GROUPS + g
                                      for _, g in rows[r0:r0 + 128]])
                rpos = positions[bi, cs].long()
                sc = q[bi, cs, hs].float() @ k[bi, :, kh].T * scale
                mask = (kpos[None] <= rpos[:, None]) & held[bi][None]
                if window:
                    mask &= kpos[None] > rpos[:, None] - window
                parts = []
                for kbeg, kend in pa.chunk_split_keys(
                        int(rpos.min()), int(rpos.max()), window, w, ps,
                        splits):
                    m_ = mask & (kpos >= kbeg)[None] & (kpos <= kend)[None]
                    sk = torch.where(m_, sc, NEG_INF)
                    ms = sk.max(-1).values.clamp(min=NEG_INF)
                    p = torch.where(m_, torch.exp(sk - ms[:, None]), 0.0)
                    parts.append((ms, p.sum(-1), p @ v[bi, :, kh]))
                m = torch.stack([x[0] for x in parts]).max(0).values
                l = torch.zeros_like(m)
                acc = torch.zeros((len(cs), d))
                for ms, ls, accs in parts:  # split order 0 .. S - 1
                    f = torch.exp(ms - m)
                    l = l + ls * f
                    acc = acc + accs * f[:, None]
                out[bi, cs, hs] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out


_JAX = {}


def _jax_chunk(mode, ps, window):
    """The JAX package's chunk on the same inputs: its Pallas kernel in
    interpret mode (cached: a call interprets every grid step)."""
    key = (mode, ps, window)
    if key not in _JAX:
        _, jpools, tab, pos, q = _setup(mode, ps)
        _JAX[key] = np.asarray(_jpp().paged_attention(
            jnp.asarray(q), jpools, jnp.asarray(tab), jnp.asarray(pos),
            scale=_D ** -0.5, window=window, kv_heads=_HKV, variant="chunk",
            interpret=True))
    return _JAX[key]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_split_chunk_equals_plain_and_jax(mode, ps, window, splits):
    assert _jpp().kernels_available(True)
    layer, _, tab, pos, q = _setup(mode, ps)
    kw = dict(scale=_D ** -0.5, window=window)
    t_tab, t_pos, t_q = (torch.from_numpy(x) for x in (tab, pos, q))
    got = _split_chunk(t_q, layer, t_tab, t_pos, splits=splits, **kw)
    plain = pa.paged_attention_reference(t_q, layer, t_tab, t_pos,
                                         kv_heads=_HKV, variant="chunk",
                                         **kw)
    live = [0, 2]
    torch.testing.assert_close(got[live], plain[live], **_TOL)
    np.testing.assert_allclose(got[live].numpy(),
                               _jax_chunk(mode, ps, window)[live],
                               **_KERNEL_TOL)
    # the free slot holds no page: the kernel's rule gives exact zeros
    assert torch.all(got[1] == 0)


# ---------------------------------------------------------------------------
# the mask, element by element
# ---------------------------------------------------------------------------


def _kernel_mask(tab_row, pos_row, groups, window, ps, splits):
    """The keys each query row of one slot and KV head sees under
    ``paged_chunk_wgmma_kernel``'s walk: per row tile of 128 rows and
    split, the split's tiles of 64 keys (``chunk_split_keys``), each with
    its mask of keys on assigned pages inside the split's range; per row
    the range [pos - window + 1, pos]. Returns (bool [n_q, W·ps], how
    many times each row met each key)."""
    w = len(tab_row)
    n_q = len(pos_row) * groups
    seen = np.zeros((n_q, w * ps), np.int32)
    for row0 in range(0, n_q, 128):
        rows = np.arange(row0, min(n_q, row0 + 128))
        rpos = pos_row[rows // groups]
        r_lo = rpos - window + 1 if window else np.zeros_like(rpos)
        for kbeg, kend in pa.chunk_split_keys(int(rpos.min()),
                                              int(rpos.max()), window, w,
                                              ps, splits):
            for k0 in range(kbeg, kend + 1, 64):
                keys = k0 + np.arange(64)
                inside = keys <= kend
                page = np.where(inside, keys // ps, 0)
                valid = inside & (tab_row[page] >= 0)
                if not valid.any():
                    continue  # never published
                ok = (valid[None] & (keys[None] >= r_lo[:, None])
                      & (keys[None] <= rpos[:, None]))
                kk = keys[valid]
                seen[rows[:, None], kk[None]] += ok[:, valid]
    return seen > 0, seen


def _jax_rule(tab_row, pos_row, groups, window, ps):
    """``_paged_kernel``'s mask (dlrover_tpu/ops/pallas_paged.py l.300) for
    one slot: page j is folded iff assigned, ``j * ps <= max_pos`` and,
    with a window, ``(j + 1) * ps - 1 > min_pos - window``; key kpos of a
    folded page serves row r iff ``kpos <= pos[r]`` and ``kpos > pos[r] -
    window``."""
    w = len(tab_row)
    rows_pos = np.repeat(pos_row, groups)
    min_pos, max_pos = pos_row[0], pos_row[-1]
    out = np.zeros((len(rows_pos), w * ps), bool)
    for j in range(w):
        page_ok = tab_row[j] >= 0 and j * ps <= max_pos
        if window:
            page_ok = page_ok and (j + 1) * ps - 1 > min_pos - window
        if not page_ok:
            continue
        kpos = j * ps + np.arange(ps)
        allowed = kpos[None] <= rows_pos[:, None]
        if window:
            allowed &= kpos[None] > rows_pos[:, None] - window
        out[:, j * ps:(j + 1) * ps] = allowed
    return out


@pytest.mark.parametrize("window", [0, 5, 300])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_kernel_mask_equals_the_jax_rule(window, ps, splits):
    """Three chunks (at 700, at 0 and ragged at 29) of 100 rows x 4 query
    heads a KV head (four row tiles, the last ragged), tables shuffled
    with a hole below the positions and -1 columns after."""
    rng = np.random.default_rng(ps + window + splits)
    w = -(-900 // ps)
    for start, c in ((700, 100), (0, 100), (29, 37)):
        need = -(-(start + c) // ps)
        tab = np.full(w, -1, np.int32)
        tab[:need] = rng.permutation(np.arange(1, 1 + need))
        tab[need // 2] = -1  # a hole some rows see
        pos = start + np.arange(c)
        got, count = _kernel_mask(tab, pos, 4, window, ps, min(splits, w))
        np.testing.assert_array_equal(got, _jax_rule(tab, pos, 4, window, ps))
        assert count.max() <= 1  # each key reaches a row once


@pytest.mark.parametrize("window", [0, 5, 20])
@pytest.mark.parametrize("splits", [1, 3])
def test_jax_kernel_shows_the_same_mask(window, splits):
    """The JAX Pallas kernel in interpret mode on q = 0 (every score 0)
    and one-hot values (V of key k is the unit vector e_k): each output
    row is the mean of the unit vectors of the keys it sees, so its
    nonzero entries are its mask. 64 keys (8 pages of 8) fill D = 64."""
    assert _jpp().kernels_available(True)
    ps, w, c, start, hkv, groups = 8, 8, 20, 40, 1, 8
    tab = np.asarray([[3, 7, -1, 1, 5, 2, 8, 4]], np.int32)  # a hole
    pos = (start + np.arange(c, dtype=np.int32))[None]
    n_pages = 9
    k = np.zeros((n_pages, ps, hkv, 64), np.float32)
    v = np.zeros_like(k)
    for j, page in enumerate(tab[0]):
        if page >= 0:
            for i in range(ps):
                v[page, i, 0, j * ps + i] = 1.0
    out = np.asarray(_jpp().paged_attention(
        jnp.zeros((1, c, hkv * groups, 64), jnp.float32),
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(tab),
        jnp.asarray(pos), scale=0.125, window=window, kv_heads=hkv,
        variant="chunk", interpret=True))
    jax_mask = out[0].reshape(c * groups, 64) > 1e-6
    got, _ = _kernel_mask(tab[0], pos[0], groups, window, ps, splits)
    np.testing.assert_array_equal(got, jax_mask)
