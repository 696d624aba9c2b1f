"""The split page walk of the decode and verify kernel, held on the CPU.

``paged_decode_split_kernel`` (``csrc/paged_attention.cu``) splits each
(slot, KV head)'s walk over the table columns into S contiguous ranges,
one block each, and the last block to finish merges the partial
``(m, l, acc)`` states in split order, then folds a verify chunk's
in-flight rows. Here:

- the planner (``plan_splits``) and the column ranges
  (``split_columns``): the ranges cover ``[0, W)`` once, 1 <= S <= W, and
  the wrapper picks S from the launch shape alone, whatever the positions
  and tables;
- ``_split_merge`` below, a plain PyTorch split-and-merge of
  ``paged_attention_reference``'s arithmetic (test-only: no path of the
  port calls it), equals the unsplit plain version for every S from 1 to
  W, with windows, empty splits, holes in a table and a free slot.
  Tolerance rtol 1e-5 / atol 1e-6: the same f32 values summed in another
  grouping (per split, then across splits).
- with ``held_only`` it skips unassigned (-1) pages as the kernel does,
  and a free slot's rows come out as exact zeros.
"""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models.config import get_config
from dlrover_tpu_torch.ops import paged_attention as pa
from dlrover_tpu_torch.serving import kv_cache as kvc

NEG_INF = -1e30
_TOL = dict(rtol=1e-5, atol=1e-6)
# three slots over pages of 4 (W = 6 columns): slot 0 with a hole in its
# table, slot 2 free
_PS, _LENS, _C = 4, (22, 9, 0), 3
_HOLE = 2  # slot 0's column 2 unassigned


def _setup(mode, seed=0):
    cfg = get_config("tiny", n_layer=1, d_model=128, n_head=4, n_kv_head=2,
                     dtype="float32")
    geom = kvc.make_geometry(cfg, n_slots=len(_LENS), max_len=24,
                             page_size=_PS, mode=mode)
    rng = np.random.default_rng(seed)
    pools = kvc.init_pools(geom, "cpu")
    for name in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal(
            (1, geom.n_pages, _PS, geom.row_elems)).astype(np.float32))
        if mode == "bf16":
            pools[name].copy_(x.reshape(pools[name].shape))
        else:
            from dlrover_tpu_torch.ops import quant

            q8, sc = quant.kv_encode_rows(x, geom.kv_block)
            pools[name + "_q"].copy_(q8)
            pools[name + "_scale"].copy_(sc)
    perm = list(rng.permutation(np.arange(1, geom.n_pages)))
    tab = np.full((len(_LENS), geom.max_pages_per_slot), -1, np.int32)
    for i, n in enumerate(_LENS):
        for j in range(-(-n // _PS)):
            tab[i, j] = perm.pop()
    tab[0, _HOLE] = -1
    q = torch.from_numpy(rng.standard_normal(
        (len(_LENS), _C, 4, 32)).astype(np.float32))
    ek, ev = (torch.from_numpy(rng.standard_normal(
        (len(_LENS), _C, 2, 32)).astype(np.float32)) for _ in "kv")
    return (q, kvc.layer_pools(pools, 0), torch.from_numpy(tab), ek, ev,
            geom.max_pages_per_slot)


def _split_merge(q, pools, tables, positions, *, splits, scale, window,
                 kv_heads, variant, extra_k=None, extra_v=None,
                 held_only=False):
    """The kernel's split-and-merge on the plain version's arithmetic:
    per split s the keys of columns ``split_columns(W, S)[s]`` give a
    partial (m, l, acc); the partials merge in split order; verify then
    folds the in-flight rows once. ``held_only``: keys on -1 pages are
    skipped (the kernel's rule) instead of read from the trash page."""
    b, c, h, d = q.shape
    k, v = pa.gather_pages(pools, tables, kv_heads=kv_heads,
                           dtype=torch.float32)
    w = tables.shape[1]
    ps = k.shape[1] // w
    groups = h // kv_heads
    pos = torch.as_tensor(positions).reshape(b, -1).expand(b, c).long()
    qg = q.float().reshape(b, c, kv_heads, groups, d)
    s = torch.einsum("bckgd,bskd->bckgs", qg, k.float()) * scale
    kpos = torch.arange(w * ps)
    mask = kpos[None, None, :] <= pos[:, :, None]
    if variant == "verify":
        mask = mask & (kpos[None, None, :] < pos[:, :1, None])
    if window:
        mask = mask & (kpos[None, None, :] > pos[:, :, None] - window)
    if held_only:
        held = (tables >= 0).long().repeat_interleave(ps, dim=1).bool()
        mask = mask & held[:, None, :]
    mask = mask[:, :, None, None, :]
    m = torch.full((b, c, kv_heads, groups), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, c, kv_heads, groups, d))
    parts = []
    for c0, c1 in pa.split_columns(w, splits):
        keys = slice(c0 * ps, c1 * ps)
        sk = torch.where(mask[..., keys], s[..., keys], NEG_INF)
        ms = sk.max(-1).values.clamp(min=NEG_INF)
        p = torch.where(mask[..., keys], torch.exp(sk - ms[..., None]), 0.0)
        parts.append((ms, p.sum(-1), torch.einsum(
            "bckgs,bskd->bckgd", p, v.float()[:, keys])))
    m = torch.stack([x[0] for x in parts]).max(0).values
    for ms, ls, accs in parts:  # split order 0 .. S - 1
        f = torch.exp(ms - m)
        l = l + ls * f
        acc = acc + accs * f[..., None]
    if variant == "verify":
        se = torch.einsum("bckgd,bekd->bckge", qg, extra_k.float()) * scale
        emask = pos[:, None, :] <= pos[:, :, None]
        if window:
            emask = emask & (pos[:, None, :] > pos[:, :, None] - window)
        emask = emask[:, :, None, None, :]
        se = torch.where(emask, se, NEG_INF)
        m_new = torch.maximum(m, se.max(-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.where(emask, torch.exp(se - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bckge,bekd->bckgd", p, extra_v.float())
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, c, h, d)


def _call(mode, variant, window):
    q, pools, tab, ek, ev, w = _setup(mode)
    if variant == "decode":
        q = q[:, :1].contiguous()
        pos = torch.as_tensor([n - 1 if n else 0 for n in _LENS],
                              dtype=torch.int32)
        extra = {}
    else:
        start = np.maximum(np.asarray(_LENS) - _C - 1, 0)
        pos = torch.as_tensor(start[:, None] + np.arange(_C),
                              dtype=torch.int32)
        extra = dict(extra_k=ek, extra_v=ev)
    kw = dict(scale=32 ** -0.5, window=window, kv_heads=2, variant=variant,
              **extra)
    return q, pools, tab, pos, kw, w


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("variant", ["decode", "verify"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6])
def test_split_merge_equals_the_plain_version(mode, variant, window, splits):
    q, pools, tab, pos, kw, w = _call(mode, variant, window)
    assert splits <= w
    want = pa.paged_attention_reference(q, pools, tab, pos, **kw)
    got = _split_merge(q, pools, tab, pos, splits=splits, **kw)
    torch.testing.assert_close(got, want, **_TOL)


@pytest.mark.parametrize("variant", ["decode", "verify"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("splits", [1, 3, 6])
def test_split_merge_skips_unassigned_pages(variant, window, splits):
    """The kernel's rule: keys on -1 pages are never read. Slot 0's hole
    at column 2 lies below its positions, so it changes slot 0's result;
    the other held slot matches the plain version and the free slot (no
    page at all) comes out as exact zeros in decode (verify still sees its
    in-flight rows)."""
    q, pools, tab, pos, kw, w = _call("int8", variant, window)
    want = pa.paged_attention_reference(q, pools, tab, pos, **kw)
    got = _split_merge(q, pools, tab, pos, splits=splits, held_only=True,
                       **kw)
    one = _split_merge(q, pools, tab, pos, splits=1, held_only=True, **kw)
    torch.testing.assert_close(got, one, **_TOL)
    torch.testing.assert_close(got[1], want[1], **_TOL)
    if variant == "decode":
        assert torch.all(got[2] == 0)
        # the hole is seen (it holds keys 8..11 below position 21) unless
        # the window of 5 already hides it
        assert (window == 0) == bool((got[0] - want[0]).abs().max() > 1e-4)
    else:
        filled = tab.clone()
        filled[0, _HOLE] = 0  # the trash page, as the plain version reads it
        torch.testing.assert_close(
            _split_merge(q, pools, filled, pos, splits=splits, **kw), want,
            **_TOL)


@pytest.mark.parametrize("w", [1, 2, 5, 64, 128, 131])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64, 200])
def test_split_columns_cover_the_walk_once(w, splits):
    splits = min(splits, w)
    cols = pa.split_columns(w, splits)
    assert len(cols) == splits
    covered = [j for c0, c1 in cols for j in range(c0, c1)]
    assert covered == list(range(w))  # in order, each column once
    assert all(c1 > c0 for c0, c1 in cols)  # S <= W: no split is empty


@pytest.mark.parametrize("b,hkv,tiles,w,ps,n_sm", [
    (8, 8, 1, 128, 16, 132), (1, 8, 1, 128, 16, 132), (1, 1, 1, 4, 1, 132),
    (8, 8, 3, 128, 16, 132), (64, 8, 1, 128, 16, 132), (2, 2, 1, 256, 8, 132),
    (1, 2, 1, 1, 16, 132), (1, 2, 1, 0, 16, 132), (4, 2, 1, 12, 32, 16),
    (1, 1, 1, 512, 16, 132)])
def test_plan_splits_bounds(b, hkv, tiles, w, ps, n_sm):
    s = pa.plan_splits(b, hkv, tiles, w, ps, n_sm)
    assert 1 <= s <= min(max(w, 1), 64)
    # every split holds at least two stages of keys where the walk allows
    assert s == 1 or w * ps // s >= 2 * pa.SPLIT_KEYS
    # about eight blocks an SM, never more splits than that asks for
    assert b * hkv * tiles * (s - 1) < 8 * n_sm


def test_llama3_8b_decode_fills_the_card():
    """llama3-8b's decode (8 slots x 8 KV heads, 128 columns of 16) runs
    about eight blocks an SM of an H100; one slot alone splits its walk
    over 32 blocks a KV head, two stages of 32 keys each."""
    assert pa.plan_splits(8, 8, 1, 128, 16, 132) == 17
    assert pa.plan_splits(1, 8, 1, 128, 16, 132) == 32


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("variant", ["decode", "verify"])
def test_the_wrapper_splits_by_shape_alone(monkeypatch, variant):
    """The split count and the workspace the wrapper passes depend on the
    launch shape, not on positions or table contents."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(pa, "_sm_count", lambda dev: 132)  # an H100's
    rec = _Recorder()
    monkeypatch.setattr(pa, "_kernel", lambda: rec)
    q, pools, tab, pos, kw, w = _call("int8", variant, 0)
    rng = np.random.default_rng(3)
    seen = set()
    for trial in range(3):
        t = tab if trial == 0 else torch.from_numpy(
            rng.permutation(tab.numpy().ravel()).reshape(tab.shape))
        p = pos if trial == 0 else (pos + trial) % 7
        pa._paged_call(q, pools, t, p, max_pages=None, **kw)
        args = rec.calls[-1]
        seen.add(args[27])
        assert (args[25] is None) == (args[27] == 1)
    assert seen == {pa.plan_splits(3, 2, 1, w, _PS, 132)}
    pa.reset_launches()


# ---------------------------------------------------------------------------
# the tensor-core chunk kernel's split walk (paged_chunk_wgmma_kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,hkv,tiles,w,ps,n_sm", [
    (1, 8, 8, 128, 16, 132), (1, 8, 7, 128, 16, 132), (2, 8, 8, 128, 16, 132),
    (8, 8, 8, 128, 16, 132), (1, 8, 16, 128, 16, 132), (1, 2, 1, 4, 16, 132),
    (1, 2, 1, 1, 16, 132), (1, 2, 1, 0, 16, 132), (3, 2, 2, 12, 8, 132),
    (1, 1, 1, 512, 32, 132), (1, 8, 8, 64, 32, 16), (4, 2, 1, 200, 1, 132)])
def test_plan_chunk_splits_bounds(b, hkv, tiles, w, ps, n_sm):
    s = pa.plan_chunk_splits(b, hkv, tiles, w, ps, n_sm)
    assert 1 <= s <= min(max(w, 1), 64)
    # shape-only and deterministic: the same call, the same answer
    assert s == pa.plan_chunk_splits(b, hkv, tiles, w, ps, n_sm)
    # every split holds at least four tiles of 64 keys where the walk
    # allows; the blocks fit one wave, one an SM
    assert s == 1 or w * ps // s >= 4 * pa.CHUNK_KEYS
    assert s == 1 or b * hkv * tiles * s <= n_sm


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("c", [200, 256, 512])
def test_llama3_8b_prefill_chunks_fill_the_card(b, c):
    """llama3-8b (8 KV heads, 4 query heads each, pages of 16, a 128-column
    walk): every prefill chunk shape the engine runs fills one wave of an
    H100's 132 SMs, short of it by less than one split's row tiles; the
    timed one (B 1, C 256: 64 row tiles, half the SMs) splits each walk
    in two (128 blocks)."""
    tiles = b * 8 * -(-c * 4 // pa.SPLIT_ROWS["chunk"])
    s = pa.plan_chunk_splits(b, 8, tiles // (b * 8), 128, 16, 132)
    assert tiles * s <= max(132, tiles)
    assert tiles * (s + 1) > 132
    if (b, c) == (1, 256):
        assert (tiles, s) == (64, 2)


def _chunk_call(seed=0, c=37):
    """A bf16 chunk of head_dim 64 (the tensor-core kernel's) over three
    slots, the middle one free."""
    rng = np.random.default_rng(seed)
    cfg = get_config("tiny", n_layer=1, d_model=256, n_head=4, n_kv_head=2,
                     dtype="bfloat16")
    geom = kvc.make_geometry(cfg, n_slots=3, max_len=512, page_size=16,
                             mode="int8")
    pools = kvc.layer_pools(kvc.init_pools(geom, "cpu"), 0)
    tab = torch.full((3, geom.max_pages_per_slot), -1, dtype=torch.int32)
    perm = rng.permutation(np.arange(1, geom.n_pages))
    tab[0, :25] = torch.as_tensor(perm[:25])
    tab[2, :3] = torch.as_tensor(perm[25:28])
    start = torch.as_tensor([[360], [0], [0]], dtype=torch.int32)
    pos = start + torch.arange(c, dtype=torch.int32)
    q = torch.zeros((3, c, 4, 64), dtype=torch.bfloat16)
    return q, pools, tab, pos


def test_the_wrapper_splits_the_chunk_by_shape_alone(monkeypatch):
    """The tensor-core chunk kernel gets the split count of
    ``plan_chunk_splits`` and the workspace for it, whatever the
    positions and table contents; the CUDA-core chunk kernel (D 32, f32)
    never splits."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(pa, "_sm_count", lambda dev: 132)
    rec = _Recorder()
    monkeypatch.setattr(pa, "_kernel", lambda: rec)
    q, pools, tab, pos = _chunk_call()
    w = tab.shape[1]
    want = pa.plan_chunk_splits(3, 2, 1, w, 16, 132)
    assert want > 1
    rng = np.random.default_rng(5)
    for trial in range(3):
        t = tab if trial == 0 else torch.from_numpy(
            rng.permutation(tab.numpy().ravel()).reshape(tab.shape))
        p = pos if trial == 0 else (pos + 7 * trial) % 300
        pa._paged_call(q, pools, t, p, scale=0.125, window=0, kv_heads=2,
                       max_pages=None, variant="chunk")
        args = rec.calls[-1]
        assert args[23] == pa.CUDA_KERNEL_IDS["paged_chunk_wgmma_kernel"]
        assert args[27] == want and args[25] is not None
    ws = pa._workspaces["cpu"]
    assert ws["part"].numel() >= 3 * 2 * 1 * want * 128 * (64 + 2)
    # f32: the CUDA-core chunk kernel, one launch a row tile, no split
    pa._paged_call(q.float(), pools, tab, pos, scale=0.125, window=0,
                   kv_heads=2, max_pages=None, variant="chunk")
    assert rec.calls[-1][23] == pa.CUDA_KERNEL_IDS["paged_chunk_kernel"]
    assert rec.calls[-1][27] == 1 and rec.calls[-1][25] is None
    pa.reset_launches()


@pytest.mark.parametrize("lo,hi,window", [
    (1536, 1791, 0), (1536, 1791, 512), (0, 36, 0), (0, 0, 0), (310, 346, 300),
    (700, 799, 5), (5, 3000, 0)])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
def test_chunk_split_keys_cover_the_visible_keys_once(lo, hi, window,
                                                      splits):
    """The chunk kernel's splits walk the keys a row tile may see, [lo -
    window + 1, hi] cut to a 128-column table of pages of 16, each key
    once and in order, in whole tiles of 64 keys but the last; the
    splits' tile counts differ by at most one (an empty split: none)."""
    w, ps = 128, 16
    keys = pa.chunk_split_keys(lo, hi, window, w, ps, splits)
    assert len(keys) == splits
    walked = [k for kbeg, kend in keys for k in range(kbeg, kend + 1)]
    first = max(0, lo - window + 1) if window else 0
    assert walked == list(range(first, min(hi, w * ps - 1) + 1))
    tiles = [-(-(kend - kbeg + 1) // pa.CHUNK_KEYS) for kbeg, kend in keys]
    assert max(tiles) - min(tiles) <= 1
    for kbeg, kend in keys[:-1]:
        n = kend - kbeg + 1
        assert n <= 0 or n % pa.CHUNK_KEYS == 0
