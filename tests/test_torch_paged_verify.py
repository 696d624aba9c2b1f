"""The ``verify`` variant of paged attention: the port's plain version
against the JAX package.

The same pools (written by the JAX write path from seeded numpy rows,
then copied byte for byte into torch tensors), tables, queries and
in-flight chunk rows go through
``dlrover_tpu.ops.pallas_paged.paged_attention_reference(variant=
"verify")`` and the port's ``paged_attention_reference``, and through
the Pallas kernel in interpret mode where the interpreter runs here.
The pools hold rows at the chunk's own positions and beyond (another
tenant's stale rows, as a copy-on-write tail page or a recycled page
holds them): only the ``kpos < start`` mask hides them. Tables are
shuffled with -1 tails. Tolerances, as in
``tests/test_torch_paged_attention.py``:

- f32 compute, plain vs plain: rtol 1e-5 / atol 1e-6 — the same ops in
  the same order; only the two frameworks' exp/sum roundings differ.
- bf16 compute, plain vs plain: rtol/atol 1e-2 — one bf16 rounding of
  the output may land on the other side of a tie.
- plain vs the Pallas kernel (interpret): rtol/atol 2e-2 in bf16 and
  1e-4 in f32 (online softmax reassociates the sums).
- Inside the port, verify row j against a sequential decode at the same
  position after the chunk's rows 0..j are written: 1e-6 in f32 (the
  same keys, summed over another key order).
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

_TOL = {
    "float32": dict(rtol=1e-5, atol=1e-6),
    "bfloat16": dict(rtol=1e-2, atol=1e-2),
}
_KERNEL_TOL = {
    "float32": dict(rtol=1e-4, atol=1e-4),
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
}
# slots hold LENS tokens of rows; the chunk of C queries starts at START,
# so cells START.. hold stale rows of the same slot's earlier tenant
_LENS = (22, 14, 9)
_START = (15, 6, 4)
_C = 4


def _jax_paged():
    from dlrover_tpu.ops import pallas_paged

    return pallas_paged


def _cfg(**kw):
    base = dict(n_layer=1, d_model=32, d_ff=64, n_head=4, vocab_size=32,
                max_seq=64)
    base.update(kw)
    return get_config("tiny", **base)


def _setup(mode, cfg, seed=0):
    """Identical JAX and torch pools holding seeded rows at every
    position below each slot's length, over shuffled pages whose table
    rows end in -1; queries and in-flight rows for a chunk of ``_C``
    positions from ``_START``."""
    n_slots = len(_LENS)
    geom = tkv.make_geometry(cfg, n_slots=n_slots, max_len=32, page_size=4,
                             mode=mode)
    rng = np.random.default_rng(seed)
    alloc = tkv.PageAllocator(geom, n_slots)
    # interleave the slots' pages: grow each in turns of one page
    for n in range(4, max(_LENS) + 4, 4):
        for i, total in enumerate(_LENS):
            assert alloc.ensure(i, min(n, total))
    tables = alloc.block_tables()
    assert (tables < 0).any()
    c = max(_LENS)
    shape = (cfg.n_layer, n_slots, c, cfg.kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    positions = np.broadcast_to(np.arange(c, dtype=np.int32), (n_slots, c))
    valid = np.arange(c)[None, :] < np.asarray(_LENS)[:, None]
    jgeom = jkv.PageGeometry(*geom)
    dt = jnp.dtype(cfg.dtype)
    jpools = jkv.write_rows(
        jkv.init_pools(jgeom), jnp.asarray(tables), jnp.asarray(positions),
        jnp.asarray(valid), jnp.asarray(k).astype(dt),
        jnp.asarray(v).astype(dt), jgeom,
    )
    tpools = {
        name: torch.from_numpy(np.asarray(
            arr.astype(jnp.float32) if arr.dtype == jnp.bfloat16 else arr
        ).copy())
        for name, arr in jpools.items()
    }
    for name in ("k", "v"):
        if name in tpools:
            tpools[name] = tpools[name].to(getattr(torch, cfg.dtype))
    pos = (np.asarray(_START, np.int32)[:, None]
           + np.arange(_C, dtype=np.int32)[None, :])
    q = rng.standard_normal((n_slots, _C, cfg.n_head, cfg.head_dim))
    ek = rng.standard_normal((n_slots, _C, cfg.kv_heads, cfg.head_dim))
    ev = rng.standard_normal((n_slots, _C, cfg.kv_heads, cfg.head_dim))
    both = [(jnp.asarray(x.astype(np.float32)).astype(dt),
             torch.from_numpy(x.astype(np.float32)).to(getattr(torch,
                                                               cfg.dtype)))
            for x in (q, ek, ev)]
    return geom, tables, pos, jpools, tpools, both


def _layer(pools, i=0):
    return {k: v[i] for k, v in pools.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _both(cfg, mode, window, **kw):
    _, tables, pos, jpools, tpools, ((jq, tq), (jk, tk), (jv, tv)) = \
        _setup(mode, cfg)
    args = dict(scale=cfg.head_dim ** -0.5, window=window,
                kv_heads=cfg.kv_heads, variant="verify")
    ref = _jax_paged().paged_attention_reference(
        jq, _layer(jpools), jnp.asarray(tables), jnp.asarray(pos),
        extra_k=jk, extra_v=jv, **args, **kw)
    out = tpa.paged_attention_reference(
        tq, _layer(tpools), torch.from_numpy(tables), torch.from_numpy(pos),
        extra_k=tk, extra_v=tv, **args, **kw)
    return ref, out, (jq, jk, jv, jpools, tables, pos, args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_verify_plain_matches_jax(mode, window, gqa, dtype):
    cfg = _cfg(attn_window=window, n_kv_head=2 if gqa else None, dtype=dtype)
    ref, out, _ = _both(cfg, mode, window)
    assert out.shape == ref.shape and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), _np(ref), **_TOL[dtype])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_verify_partial_walk_matches_jax(mode):
    """A walk cut to the pages held (``max_pages``) over -1 tails."""
    cfg = _cfg(n_kv_head=2, dtype="float32")
    ref, out, _ = _both(cfg, mode, 0, max_pages=6)
    np.testing.assert_allclose(_np(out), _np(ref), **_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_verify_plain_matches_pallas_kernel_interpret(mode, dtype):
    """The Pallas kernel's verify column (interpret mode), GQA + window,
    against the port's plain version: the port's CUDA kernel is held
    against the same plain version on the card."""
    if not _jax_paged().kernels_available(True):
        pytest.skip("pallas tpu backend not importable")
    cfg = _cfg(attn_window=6, n_kv_head=2, dtype=dtype)
    _, out, (jq, jk, jv, jpools, tables, pos, args) = _both(cfg, mode, 6)
    kern = _jax_paged().paged_attention(
        jq, _layer(jpools), jnp.asarray(tables), jnp.asarray(pos),
        interpret=True, extra_k=jk, extra_v=jv, **args)
    np.testing.assert_allclose(_np(out), _np(kern), **_KERNEL_TOL[dtype])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_stale_rows_at_chunk_positions_are_invisible(mode):
    """Overwriting every pool cell at or past ``start`` (what another
    tenant could leave there) changes nothing; changing in-flight row i
    changes only the query rows j >= i."""
    cfg = _cfg(n_kv_head=2, dtype="float32")
    geom, tables, pos, _, tpools, (_, (_, tk), (_, tv)) = _setup(mode, cfg)
    tq = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (len(_LENS), _C, cfg.n_head, cfg.head_dim)).astype(np.float32))
    kw = dict(scale=0.3, kv_heads=cfg.kv_heads, variant="verify")

    def run(pools, ek):
        return tpa.paged_attention_reference(
            tq, _layer(pools), torch.from_numpy(tables),
            torch.from_numpy(pos), extra_k=ek, extra_v=tv, **kw)

    base = run(tpools, tk)
    stale = {n: t.clone() for n, t in tpools.items()}
    ps = geom.page_size
    for b, s in enumerate(_START):
        for p in range(s, geom.max_len):
            page = tables[b, p // ps]
            if page > 0:
                for t in stale.values():
                    t[0, page, p % ps] = 7
    assert torch.equal(run(stale, tk), base)
    ek = tk.clone()
    ek[:, 2] += 1.0
    moved = (run(tpools, ek) - base).abs().amax(dim=(2, 3))
    assert torch.all(moved[:, :2] == 0) and torch.all(moved[:, 2:] > 0)


def test_verify_row_equals_sequential_decode():
    """Verify row j is the decode variant at position start + j once the
    chunk's rows 0..j sit in their page cells (f32 pools: written
    verbatim, so the keys are identical)."""
    cfg = _cfg(n_kv_head=2, dtype="float32", attn_window=9)
    _, tables, pos, _, tpools, ((_, tq), (_, tk), (_, tv)) = \
        _setup("bf16", cfg)
    layer = _layer(tpools)
    kw = dict(scale=0.3, kv_heads=cfg.kv_heads, window=9)
    out = tpa.paged_attention_reference(
        tq, layer, torch.from_numpy(tables), torch.from_numpy(pos),
        extra_k=tk, extra_v=tv, variant="verify", **kw)
    tab = torch.from_numpy(tables)
    for j in range(_C):
        valid = torch.ones((len(_LENS), 1), dtype=torch.bool)
        tpa.write_page_rows(layer, tab, torch.from_numpy(pos[:, j:j + 1]),
                            valid, tk[:, j:j + 1], tv[:, j:j + 1])
        dec = tpa.paged_attention_reference(
            tq[:, j:j + 1], layer, tab, torch.from_numpy(pos[:, j]), **kw)
        torch.testing.assert_close(out[:, j:j + 1], dec, rtol=1e-6,
                                   atol=1e-6)


def test_cpu_verify_dispatch_is_the_plain_version_and_never_counts():
    cfg = _cfg(n_kv_head=2)
    _, tables, pos, _, tpools, ((_, tq), (_, tk), (_, tv)) = \
        _setup("int8", cfg)
    kw = dict(scale=cfg.head_dim ** -0.5, kv_heads=cfg.kv_heads,
              variant="verify")
    args = (tq, _layer(tpools), torch.from_numpy(tables),
            torch.from_numpy(pos))
    tpa.reset_launches()
    out = tpa.paged_attention(*args, extra_k=tk, extra_v=tv, **kw)
    ref = tpa.paged_attention_reference(*args, extra_k=tk, extra_v=tv, **kw)
    assert torch.equal(out, ref)
    assert tpa.LAUNCHES == {"decode": 0, "chunk": 0, "verify": 0}
    with pytest.raises(ValueError, match="extra_k"):
        tpa.paged_attention(*args, **kw)
    with pytest.raises(ValueError, match="positions"):
        tpa.paged_attention(tq, _layer(tpools), torch.from_numpy(tables),
                            torch.from_numpy(pos[:, 0]), extra_k=tk,
                            extra_v=tv, **kw)


def test_verify_counts_under_its_own_kernel_and_the_wrapper_checks_rows():
    """``verify`` launches always count under ``verify``, whatever the
    row count; the wrapper checks the in-flight rows before any launch
    (these checks run before it touches CUDA, so they run here)."""
    for c, h, hkv in ((5, 32, 8), (1, 4, 4), (64, 16, 1)):
        assert tpa.kernel_for(c, h, hkv, "verify") == "verify"
    cfg = _cfg(n_kv_head=2, d_model=128)  # head_dim 32
    _, tables, pos, _, tpools, ((_, tq), (_, tk), (_, tv)) = \
        _setup("bf16", cfg)
    kw = dict(scale=1.0, kv_heads=cfg.kv_heads, max_pages=None, window=0,
              variant="verify")
    args = (tq, _layer(tpools), torch.from_numpy(tables),
            torch.from_numpy(pos))
    with pytest.raises(ValueError, match="extra_k"):
        tpa._paged_call(*args, **kw)
    with pytest.raises(ValueError, match="extra_v has shape"):
        tpa._paged_call(*args, extra_k=tk, extra_v=tv[:, :2], **kw)
    with pytest.raises(TypeError, match="extra_k must be"):
        tpa._paged_call(*args, extra_k=tk.double(), extra_v=tv, **kw)
