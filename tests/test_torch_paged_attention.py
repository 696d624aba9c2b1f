"""Paged attention: the port's plain version against the JAX package.

The same pools (made by the JAX write path from seeded numpy rows, then
copied byte for byte into torch tensors), tables and queries go through
``dlrover_tpu.ops.pallas_paged.paged_attention_reference`` and
``dlrover_tpu_torch.ops.paged_attention.paged_attention_reference``,
and through the Pallas kernel in interpret mode where the interpreter
runs here. Tolerances:

- f32 compute, plain vs plain: rtol 1e-5 / atol 1e-6 — the same ops in
  the same order; only the two frameworks' exp/sum roundings differ.
- bf16 compute, plain vs plain: atol/rtol 1e-2 — one bf16 rounding of
  the output (and, in the chunk variant, of the probabilities) may land
  on the other side of a tie.
- plain vs the Pallas kernel (interpret): rtol/atol 2e-2 in bf16 (the
  JAX package's own kernel-vs-reference bound) and 1e-4 in f32 (online
  softmax reassociates the sums).

The kernel-facing helpers (``write_page_rows``, ``gather_pages``) must
match the JAX ones exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.serving import kv_cache as jkv  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from dlrover_tpu_torch.serving import kv_cache as tkv  # noqa: E402

_LENS = (9, 14, 3)
_TOL = {
    "float32": dict(rtol=1e-5, atol=1e-6),
    "bfloat16": dict(rtol=1e-2, atol=1e-2),
}
_KERNEL_TOL = {
    "float32": dict(rtol=1e-4, atol=1e-4),
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
}


def _jax_paged():
    # the JAX module holding the reference and the Pallas kernel
    from dlrover_tpu.ops import pallas_paged

    return pallas_paged


def _cfg(**kw):
    base = dict(n_layer=2, d_model=32, d_ff=64, n_head=4, vocab_size=32,
                max_seq=64)
    base.update(kw)
    return get_config("tiny", **base)


def _fragmented_alloc(geom, n_slots, rng):
    """A port allocator after a random admit/grow/evict trace: pages
    behind each slot are shuffled and interleaved, and slots stay under
    half the table so every row ends in -1 columns."""
    alloc = tkv.PageAllocator(geom, n_slots)
    cap = geom.max_len // 2
    lens = [0] * n_slots
    for _ in range(60):
        slot = int(rng.integers(n_slots))
        if lens[slot] == 0:
            n = int(rng.integers(1, cap + 1))
            if alloc.can_admit(n):
                alloc.admit(slot, n)
                lens[slot] = n
        elif rng.random() < 0.4:
            alloc.evict(slot)
            lens[slot] = 0
        else:
            n = min(cap, lens[slot] + int(rng.integers(0, 5)))
            if alloc.ensure(slot, n):
                lens[slot] = n
    for slot in range(n_slots):  # every slot live, so every row is checked
        if lens[slot] == 0:
            assert alloc.admit(slot, 5)
            lens[slot] = 5
    return alloc, lens


def _setup(mode, cfg, *, fragmented=False, lens=_LENS, seed=0):
    """Identical JAX and torch pools holding seeded K/V rows."""
    n_slots = len(lens)
    geom = tkv.make_geometry(cfg, n_slots=n_slots, max_len=32, page_size=4,
                             mode=mode)
    rng = np.random.default_rng(seed)
    if fragmented:
        alloc, lens = _fragmented_alloc(geom, n_slots, rng)
    else:
        alloc = tkv.PageAllocator(geom, n_slots)
        for i, n in enumerate(lens):
            assert alloc.admit(i, n)
    tables = alloc.block_tables()
    c = max(lens)
    shape = (cfg.n_layer, n_slots, c, cfg.kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    positions = np.broadcast_to(np.arange(c, dtype=np.int32), (n_slots, c))
    valid = np.arange(c)[None, :] < np.asarray(lens)[:, None]
    jgeom = jkv.PageGeometry(*geom)
    dt = jnp.dtype(cfg.dtype)
    jpools = jkv.write_rows(
        jkv.init_pools(jgeom), jnp.asarray(tables), jnp.asarray(positions),
        jnp.asarray(valid), jnp.asarray(k).astype(dt),
        jnp.asarray(v).astype(dt), jgeom,
    )
    tpools = {
        name: torch.from_numpy(np.asarray(arr.astype(jnp.float32)
                                          if arr.dtype == jnp.bfloat16
                                          else arr).copy())
        for name, arr in jpools.items()
    }
    for name in ("k", "v"):
        if name in tpools:
            tpools[name] = tpools[name].to(getattr(torch, cfg.dtype))
    return geom, lens, tables, jpools, tpools


def _layer(pools, i):
    return {k: v[i] for k, v in pools.items()}


def _queries(cfg, b, c, seed=7):
    q = np.random.default_rng(seed).standard_normal(
        (b, c, cfg.n_head, cfg.head_dim)).astype(np.float32)
    return (jnp.asarray(q).astype(jnp.dtype(cfg.dtype)),
            torch.from_numpy(q).to(getattr(torch, cfg.dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _chunk_positions(lens, c):
    last = np.asarray(lens) - 1
    return (last[:, None] - np.arange(c - 1, -1, -1)[None, :]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_decode_plain_matches_jax(mode, window, gqa, dtype):
    cfg = _cfg(attn_window=window, n_kv_head=2 if gqa else None, dtype=dtype)
    _, lens, tables, jpools, tpools = _setup(mode, cfg)
    jq, tq = _queries(cfg, len(lens), 1)
    pos = np.asarray(lens, np.int32) - 1
    kw = dict(scale=cfg.head_dim ** -0.5, window=window,
              kv_heads=cfg.kv_heads)
    for layer in range(cfg.n_layer):
        ref = _jax_paged().paged_attention_reference(
            jq, _layer(jpools, layer), jnp.asarray(tables), jnp.asarray(pos),
            **kw)
        out = tpa.paged_attention_reference(
            tq, _layer(tpools, layer), torch.from_numpy(tables),
            torch.from_numpy(pos), **kw)
        assert out.dtype == tq.dtype and out.shape == tq.shape
        np.testing.assert_allclose(_np(out), _np(ref), **_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_chunk_plain_matches_jax(mode, window, gqa, dtype):
    cfg = _cfg(attn_window=window, n_kv_head=2 if gqa else None, dtype=dtype)
    _, lens, tables, jpools, tpools = _setup(mode, cfg, lens=(9, 14, 6))
    c = 4
    jq, tq = _queries(cfg, len(lens), c)
    pos = _chunk_positions(lens, c)
    kw = dict(scale=cfg.head_dim ** -0.5, window=window,
              kv_heads=cfg.kv_heads, variant="chunk")
    ref = _jax_paged().paged_attention_reference(
        jq, _layer(jpools, 1), jnp.asarray(tables), jnp.asarray(pos), **kw)
    out = tpa.paged_attention_reference(
        tq, _layer(tpools, 1), torch.from_numpy(tables),
        torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), **_TOL[dtype])


@pytest.mark.parametrize("variant", ["decode", "chunk"])
def test_int8_head_spanning_scale_blocks(variant):
    """3 KV heads × 128 make a 384-element row with 192-wide scale
    blocks, so the middle head's elements take scales from two blocks
    (``(kh·D + d) // blk``); llama3's rows are the opposite case."""
    cfg = _cfg(n_head=6, n_kv_head=3, d_model=768, dtype="float32")
    geom, lens, tables, jpools, tpools = _setup("int8", cfg)
    assert geom.kv_block == 192 and cfg.head_dim == 128
    c = 1 if variant == "decode" else 3
    jq, tq = _queries(cfg, len(lens), c)
    pos = (np.asarray(lens, np.int32) - 1 if variant == "decode"
           else _chunk_positions(lens, c))
    kw = dict(scale=cfg.head_dim ** -0.5, kv_heads=cfg.kv_heads,
              variant=variant)
    ref = _jax_paged().paged_attention_reference(
        jq, _layer(jpools, 0), jnp.asarray(tables), jnp.asarray(pos), **kw)
    out = tpa.paged_attention_reference(
        tq, _layer(tpools, 0), torch.from_numpy(tables),
        torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), **_TOL["float32"])


@pytest.mark.parametrize("variant", ["decode", "chunk"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_fragmented_tables_and_partial_walk(mode, variant):
    """Shuffled pages with -1 tails, and a walk cut to the pages held
    (``max_pages``): the plain version still matches JAX, and the cut
    changes nothing but the summation blocking of torch's CPU kernels
    (the dropped columns are all -1, their keys masked to exact zeros)."""
    cfg = _cfg(n_kv_head=2, dtype="float32")
    geom, lens, tables, jpools, tpools = _setup(mode, cfg, fragmented=True,
                                                lens=(0, 0, 0, 0))
    held = max(-(-n // geom.page_size) for n in lens)
    assert held < geom.max_pages_per_slot and (tables < 0).any()
    c = 1 if variant == "decode" else 3
    jq, tq = _queries(cfg, len(lens), c)
    pos = (np.asarray(lens, np.int32) - 1 if variant == "decode"
           else _chunk_positions(lens, c))
    kw = dict(scale=cfg.head_dim ** -0.5, kv_heads=cfg.kv_heads,
              variant=variant)
    full = tpa.paged_attention_reference(
        tq, _layer(tpools, 0), torch.from_numpy(tables),
        torch.from_numpy(pos), **kw)
    part = tpa.paged_attention_reference(
        tq, _layer(tpools, 0), torch.from_numpy(tables),
        torch.from_numpy(pos), max_pages=held, **kw)
    ref = _jax_paged().paged_attention_reference(
        jq, _layer(jpools, 0), jnp.asarray(tables), jnp.asarray(pos),
        max_pages=held, **kw)
    np.testing.assert_allclose(full.numpy(), part.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(part), _np(ref), **_TOL["float32"])


def _skip_unless_interpretable():
    if not _jax_paged().kernels_available(True):
        pytest.skip("pallas tpu backend not importable")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["decode", "chunk"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_plain_matches_pallas_kernel_interpret(mode, variant, dtype):
    """The Pallas kernel itself (interpret mode), GQA + window, against
    the port's plain version: the port's CUDA kernel is held against the
    same plain version on the card."""
    _skip_unless_interpretable()
    cfg = _cfg(attn_window=6, n_kv_head=2, dtype=dtype)
    _, lens, tables, jpools, tpools = _setup(mode, cfg, lens=(9, 14, 6))
    c = 1 if variant == "decode" else 4
    jq, tq = _queries(cfg, len(lens), c)
    pos = (np.asarray(lens, np.int32) - 1 if variant == "decode"
           else _chunk_positions(lens, c))
    kw = dict(scale=cfg.head_dim ** -0.5, window=6, kv_heads=cfg.kv_heads,
              variant=variant)
    kern = _jax_paged().paged_attention(
        jq, _layer(jpools, 0), jnp.asarray(tables), jnp.asarray(pos),
        interpret=True, **kw)
    out = tpa.paged_attention_reference(
        tq, _layer(tpools, 0), torch.from_numpy(tables),
        torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(_np(out), _np(kern), **_KERNEL_TOL[dtype])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_write_page_rows_matches_jax(mode):
    """Same phys/offset math, trash routing and int8 encode as JAX; the
    port writes in place. The trash page takes duplicate writes in both
    (which one lands is unspecified), so it is left out."""
    cfg = _cfg(dtype="bfloat16")
    geom = tkv.make_geometry(cfg, n_slots=3, max_len=32, page_size=4,
                             mode=mode)
    alloc = tkv.PageAllocator(geom, 3)
    for i, n in enumerate(_LENS):
        assert alloc.admit(i, n)
    tables = alloc.block_tables()
    rng = np.random.default_rng(8)
    shape = (3, 3, cfg.kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    # positions past the table (31 → page 7 of a 3-page slot) and
    # invalid lanes both route to the trash page
    positions = np.asarray([[0, 5, 8], [3, 13, 2], [1, 2, 31]], np.int32)
    valid = np.asarray([[True, True, True], [True, True, False],
                        [True, False, False]])
    jgeom = jkv.PageGeometry(*geom)
    jpools = _jax_paged().write_page_rows(
        _layer(jkv.init_pools(jgeom), 0), jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(valid),
        jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16),
    )
    tpools = tkv.layer_pools(tkv.init_pools(geom, "cpu"), 0)
    same = tpa.write_page_rows(
        tpools, torch.from_numpy(tables), torch.from_numpy(positions),
        torch.from_numpy(valid), torch.from_numpy(k).to(torch.bfloat16),
        torch.from_numpy(v).to(torch.bfloat16),
    )
    assert same is tpools
    for name in jpools:
        np.testing.assert_array_equal(_np(tpools[name])[1:],
                                      _np(jpools[name])[1:])
    written = sum(int((tpools[n][1:] != 0).sum()) for n in tpools)
    assert written > 0


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_gather_pages_matches_jax(mode):
    cfg = _cfg(n_kv_head=2, dtype="bfloat16")
    _, lens, tables, jpools, tpools = _setup(mode, cfg, fragmented=True,
                                             lens=(0, 0, 0))
    jk, jv = _jax_paged().gather_pages(
        _layer(jpools, 1), jnp.asarray(tables), kv_heads=cfg.kv_heads,
        max_pages=5, dtype=jnp.bfloat16)
    tk, tv = tpa.gather_pages(
        _layer(tpools, 1), torch.from_numpy(tables), kv_heads=cfg.kv_heads,
        max_pages=5, dtype=torch.bfloat16)
    np.testing.assert_array_equal(_np(tk), _np(jk))
    np.testing.assert_array_equal(_np(tv), _np(jv))


def test_cpu_dispatch_is_the_plain_version_and_never_counts():
    cfg = _cfg(n_kv_head=2)
    _, lens, tables, _, tpools = _setup("int8", cfg)
    _, tq = _queries(cfg, len(lens), 1)
    pos = torch.tensor(lens) - 1
    kw = dict(scale=cfg.head_dim ** -0.5, kv_heads=cfg.kv_heads)
    tpa.reset_launches()
    out = tpa.paged_attention(tq, _layer(tpools, 0),
                              torch.from_numpy(tables), pos, **kw)
    ref = tpa.paged_attention_reference(tq, _layer(tpools, 0),
                                        torch.from_numpy(tables), pos, **kw)
    assert torch.equal(out, ref)
    assert tpa.LAUNCHES == {"decode": 0, "chunk": 0, "verify": 0}
    # verify takes the in-flight rows (tests/test_torch_paged_verify.py)
    with pytest.raises(ValueError, match="extra_k"):
        tpa.paged_attention(tq, _layer(tpools, 0), torch.from_numpy(tables),
                            pos[:, None], variant="verify", **kw)
    with pytest.raises(ValueError, match="variant"):
        tpa.paged_attention(tq, _layer(tpools, 0), torch.from_numpy(tables),
                            pos, variant="prefill", **kw)
    with pytest.raises(ValueError, match="kv_heads"):
        tpa.paged_attention(tq, _layer(tpools, 0), torch.from_numpy(tables),
                            pos, scale=1.0)


def test_launches_count_the_kernel_the_rows_pick():
    """The decode kernel takes up to 8 query rows per (slot, KV head);
    the counter follows the kernel, whatever the variant."""
    assert tpa.KERNELS == tuple(tpa.LAUNCHES)
    assert tpa.kernel_for(1, 32, 8) == "decode"    # llama3-8b decode
    assert tpa.kernel_for(256, 32, 8) == "chunk"   # llama3-8b prefill
    assert tpa.kernel_for(2, 32, 8) == "decode"    # 8 rows: a short chunk
    assert tpa.kernel_for(1, 128, 8) == "chunk"    # 16 rows: a wide decode
    assert tpa.kernel_for(9, 4, 4) == "chunk"


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper validates shapes, types and sizes before any launch
    (these checks run before it touches CUDA, so they run here)."""
    cfg = _cfg(n_kv_head=2)  # head_dim 8: outside the kernel's set
    _, lens, tables, _, tpools = _setup("int8", cfg)
    _, tq = _queries(cfg, len(lens), 1)
    pos = torch.tensor(lens) - 1
    kw = dict(scale=1.0, kv_heads=cfg.kv_heads, max_pages=None,
              window=0, variant="decode")
    with pytest.raises(ValueError, match="head_dim"):
        tpa._paged_call(tq, _layer(tpools, 0), torch.from_numpy(tables),
                        pos, **kw)
    with pytest.raises(TypeError, match="f32/bf16"):
        tpa._paged_call(tq.half(), _layer(tpools, 0),
                        torch.from_numpy(tables), pos, **kw)
    cfg = _cfg(n_kv_head=2, d_model=128)  # head_dim 32
    _, lens, tables, _, tpools = _setup("bf16", cfg)
    _, tq = _queries(cfg, len(lens), 2)
    with pytest.raises(ValueError, match="single query"):
        tpa._paged_call(tq, _layer(tpools, 0), torch.from_numpy(tables),
                        pos, **kw)
    with pytest.raises(TypeError, match="int32"):
        tpa._paged_call(tq[:, :1].contiguous(), _layer(tpools, 0),
                        torch.from_numpy(tables).long(), pos, **kw)


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch):
    from dlrover_tpu_torch.ops import _build

    assert set(_build.sources()) == {"paged_attention", "flash_attention",
                                     "fused_norm"}
    path = _build.library_path("paged_attention")
    assert path.parent == _build.BUILD_DIR and path.name.endswith(".so")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("paged_attention") != path
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda *a: _Missing())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


class _Missing:
    """A path that does not exist, whatever is joined to it."""

    def __truediv__(self, other):
        return self

    def exists(self):
        return False
