"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips, with a reason, where no NVIDIA GPU is
present (the decision is made inside the fixture, never at import). On
a machine with a card (no JAX needed; ``tests/conftest.py`` imports
JAX, so skip it)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, paged attention: f32 queries 1e-4 (the kernel's online
softmax reassociates the f32 sums). bf16 queries are held against the
plain version run in f32 on the values the kernel reads (bf16 q and
pools upcast, int8 pages dequantized to bf16): the decode and verify
kernels at 1e-5 + 2^-8 relative (twice the kernel's one rounding of its
output to bf16); the tensor-core chunk kernel, which also rounds each
probability to bf16 before P·V, under ``chip_smoke.chunk_bound``
(2^-8·|plain| + (2^-8 + 2^-12)·M + 1e-5, M the attention over |V|).

Flash attention (a head per block, and two heads of 64 packed per
block, with and without the prefix-LM mask) and the fused norm: f32
kernels against their plain versions at 1e-4 of the largest |value|
(f32 sums in another order).
bf16 kernels against the plain versions run in f32 on the same bf16
values at 2^-6 of the largest |value|: the kernels round p or ds, and
their outputs, to bf16 (2^-8 each), and the rounding errors of up to a
thousand terms add up to a few of those (``chip_smoke.py`` holds the
same kernels element by element at the training shapes).
"""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from dlrover_tpu_torch.models import decoder
from dlrover_tpu_torch.models.config import get_config
from dlrover_tpu_torch.ops import paged_attention as pa
from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.serving import kv_cache as kvc

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -8, 1e-5)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA for sm_90a")
    return torch.device("cuda")


def _case(dev, *, mode, dtype, hkv, groups, d, ps, c, lens, window, seed):
    cfg = get_config("tiny", n_head=hkv * groups, n_kv_head=hkv,
                     d_model=hkv * groups * d, n_layer=1,
                     dtype=str(dtype).split(".")[-1])
    b = len(lens)
    geom = kvc.make_geometry(cfg, n_slots=b, max_len=ps * 12, page_size=ps,
                             mode=mode)
    g = torch.Generator(device=dev).manual_seed(seed)
    pools = kvc.init_pools(geom, dev)
    shape = (1, geom.n_pages, ps, geom.row_elems)
    for name in ("k", "v"):
        x = torch.randn(shape, generator=g, device=dev)
        if mode == "bf16":
            pools[name].copy_(x.reshape(pools[name].shape))
        else:
            qv, sc = quant.kv_encode_rows(x, geom.kv_block)
            pools[name + "_q"].copy_(qv)
            pools[name + "_scale"].copy_(sc)
    rng = np.random.default_rng(seed)
    perm = list(rng.permutation(np.arange(1, geom.n_pages)))
    tab = np.full((b, geom.max_pages_per_slot), -1, np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // ps)):
            tab[i, j] = perm.pop()
    last = np.maximum(np.asarray(lens) - 1, 0)
    pos = (last[:, None] - np.arange(c - 1, -1, -1)[None, :]).clip(0)
    q = torch.randn((b, c, hkv * groups, d), generator=g, device=dev)
    kw = dict(scale=d ** -0.5, window=window, kv_heads=hkv,
              variant="decode" if c == 1 else "chunk")
    posd = torch.as_tensor(pos[:, 0] if c == 1 else pos, dtype=torch.int32,
                           device=dev)
    return (q.to(dtype), kvc.layer_pools(pools, 0),
            torch.as_tensor(tab, device=dev), posd, kw,
            torch.as_tensor(np.asarray(lens) > 0, device=dev))


def _read_f32(pools, hkv, d):
    """One layer's pools as the kernel reads them for bf16 q, in f32."""
    if "k" in pools:
        return {n: pools[n].float() for n in ("k", "v")}
    p, ps = pools["k_q"].shape[:2]
    return {n: quant.kv_decode_rows(pools[n + "_q"], pools[n + "_scale"],
                                    torch.bfloat16).float()
            .reshape(p, ps, hkv, d) for n in ("k", "v")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize(
    "hkv,groups,d,ps,c,window",
    [(2, 4, 128, 16, 1, 0), (2, 4, 128, 16, 1, 20), (4, 1, 64, 8, 1, 0),
     (1, 8, 32, 32, 1, 0), (2, 4, 128, 16, 7, 0), (2, 2, 64, 16, 24, 13),
     (3, 4, 32, 4, 5, 0),
     # int8 rows of 3 × 128 get 192-wide scale blocks: a head spans two
     # (the llama3 shapes above are the other way round: 256-wide
     # blocks, one scale per two heads)
     (3, 2, 128, 16, 1, 0), (3, 2, 128, 16, 9, 0),
     # the kernel follows the rows per KV head, not the variant: a decode
     # of 16 query heads per KV head runs the chunk kernel, a chunk of 2
     # queries × 4 heads the decode kernel
     (1, 16, 64, 16, 1, 0), (2, 4, 64, 16, 2, 0)],
)
def test_kernel_matches_plain(dev, dtype, mode, hkv, groups, d, ps, c,
                              window):
    q, pools, tab, pos, kw, active = _case(
        dev, mode=mode, dtype=dtype, hkv=hkv, groups=groups, d=d, ps=ps,
        c=c, lens=[ps * 12, 5, 0, ps * 3 + 1], window=window, seed=c + d)
    pa.reset_launches()
    out = pa.paged_attention(q, pools, tab, pos, **kw)
    torch.cuda.synchronize()
    launched = pa.kernel_for(c, hkv * groups, hkv)
    assert pa.LAUNCHES == {k: int(k == launched) for k in pa.KERNELS}
    if pa.cuda_kernel(launched, dtype, d) == "paged_chunk_wgmma_kernel":
        # the tensor-core chunk kernel rounds p to bf16 before P·V: the
        # element-wise chunk bound of chip_smoke.py
        ref, bound = chip_smoke.chunk_bound(q, _read_f32(pools, hkv, d),
                                            tab, pos, **kw)
        assert chip_smoke._held(out, ref, active, bound)[1] == 0
    else:
        if dtype == torch.float32:
            ref = pa.paged_attention_reference(q, pools, tab, pos, **kw)
        else:
            ref = pa.paged_attention_reference(
                q.float(), _read_f32(pools, hkv, d), tab, pos, **kw)
        rtol, atol = _TOL[dtype]
        torch.testing.assert_close(out[active].float(),
                                   ref[active].float(), rtol=rtol, atol=atol)
    assert torch.all(out[~active] == 0)  # a free slot: exact zeros


def test_cuda_tensor_never_reaches_the_plain_version(dev, monkeypatch):
    q, pools, tab, pos, kw, _ = _case(
        dev, mode="int8", dtype=torch.bfloat16, hkv=2, groups=4, d=128,
        ps=16, c=1, lens=[40, 9], window=0, seed=1)

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(pa, "paged_attention_reference", forbidden)
    out = pa.paged_attention(q, pools, tab, pos, **kw)
    assert out.is_cuda and torch.isfinite(out.float()).all()
    with pytest.raises(ValueError, match="kv_heads"):
        pa.paged_attention(q, pools, tab, pos, scale=1.0)


def test_engine_on_card_matches_cpu_streams(dev):
    """Greedy streams of the tiny f32 model: the card (kernel) and the
    CPU (plain version) agree token for token."""
    from dlrover_tpu_torch.serving.server import GenerationServer

    cfg = get_config("tiny", n_layer=2, d_model=128, n_head=4, n_kv_head=2,
                     d_ff=256, vocab_size=128, max_seq=64, dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 128, size=n)))
               for n in (3, 17, 9, 30)]
    outs = {}
    for where in ("cpu", "cuda"):
        model = decoder.init(cfg, seed=0, device="cpu").to(where)
        server = GenerationServer(model, cfg, device=where, n_slots=3,
                                  max_len=64, page_size=16, mode="int8",
                                  prefill_chunk=16).start()
        try:
            outs[where] = [server.generate(p, 8, timeout=120)
                           for p in prompts]
        finally:
            server.stop()
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# the verify variant (speculative decoding)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize(
    "hkv,groups,d,ps,c,window",
    [(2, 4, 128, 16, 5, 0), (2, 4, 128, 16, 5, 20), (4, 1, 64, 8, 3, 0),
     (1, 8, 32, 32, 2, 0), (3, 2, 128, 16, 4, 7),
     # more in-flight rows than one 16-key step of the fold
     (2, 4, 64, 16, 17, 0)],
)
def test_verify_kernel_matches_plain(dev, dtype, mode, hkv, groups, d, ps, c,
                                     window):
    """Every slot's cells from its chunk's start on hold other rows (the
    stale rows an earlier tenant leaves); slot 2 is free (no pages)."""
    lens = [ps * 12, c + 5, 0, ps * 3 + 1]
    q, pools, tab, _, kw, _ = _case(
        dev, mode=mode, dtype=dtype, hkv=hkv, groups=groups, d=d, ps=ps,
        c=c, lens=lens, window=window, seed=c + d + 1)
    start = np.maximum(np.asarray(lens) - c - 2, 0)
    pos = torch.as_tensor(start[:, None] + np.arange(c)[None, :],
                          dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(c)
    ek, ev = (torch.randn((len(lens), c, hkv, d), generator=g,
                          device=dev).to(dtype) for _ in "kv")
    kw = dict(kw, variant="verify")
    pa.reset_launches()
    out = pa.paged_attention(q, pools, tab, pos, extra_k=ek, extra_v=ev,
                             **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == {k: int(k == "verify") for k in pa.KERNELS}
    if dtype == torch.float32:
        ref = pa.paged_attention_reference(q, pools, tab, pos, extra_k=ek,
                                           extra_v=ev, **kw)
    else:
        ref = pa.paged_attention_reference(
            q.float(), _read_f32(pools, hkv, d), tab, pos,
            extra_k=ek.float(), extra_v=ev.float(), **kw)
    rtol, atol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the split walk of paged_decode_split_kernel (decode and verify)
# ---------------------------------------------------------------------------


def _split_case(dev, *, mode, dtype, ps, lens, holes=(), hkv=2, groups=4,
                d=128, max_len=2048, seed=0):
    """Pools of ``hkv`` KV heads of ``d`` holding random rows, a shuffled
    table per slot covering ``lens[i]`` tokens (0: a free slot), with the
    columns in ``holes`` set to -1 in slot 0's row; queries of
    ``hkv · groups`` heads. Returns (q maker, layer pools, tables, f32
    pools as the kernel reads them, max_pages)."""
    cfg = get_config("tiny", n_head=hkv * groups, n_kv_head=hkv,
                     d_model=hkv * groups * d, n_layer=1,
                     dtype=str(dtype).split(".")[-1])
    geom = kvc.make_geometry(cfg, n_slots=len(lens), max_len=max_len,
                             page_size=ps, mode=mode)
    g = torch.Generator(device=dev).manual_seed(seed)
    pools = kvc.init_pools(geom, dev)
    for name in ("k", "v"):
        x = torch.randn((1, geom.n_pages, ps, geom.row_elems), generator=g,
                        device=dev)
        if mode == "bf16":
            pools[name].copy_(x.reshape(pools[name].shape))
        else:
            qv, sc = quant.kv_encode_rows(x, geom.kv_block)
            pools[name + "_q"].copy_(qv)
            pools[name + "_scale"].copy_(sc)
    rng = np.random.default_rng(seed)
    tab = chip_smoke._fragmented_tables(len(lens), geom.max_pages_per_slot,
                                        lens, ps, rng)
    tab[0, list(holes)] = -1
    layer = kvc.layer_pools(pools, 0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (rnd, layer, torch.as_tensor(tab, device=dev),
            _read_f32(layer, hkv, d), geom.max_pages_per_slot)


def _split_plain(q, layer, f32, tab, pos, **kw):
    """The plain version the split kernel is held to: in q's dtype for
    f32, else in f32 on the values the kernel reads."""
    if q.dtype == torch.float32:
        return pa.paged_attention_reference(q, layer, tab, pos, **kw)
    extra = {k: v.float() for k, v in kw.items() if k.startswith("extra")}
    return pa.paged_attention_reference(q.float(), f32, tab, pos,
                                        **dict(kw, **extra))


def _held_keys_plain(q, f32, tab, pos, *, scale, window, kv_heads,
                     max_pages):
    """The plain decode math in f32 over the keys of assigned pages only:
    the kernel skips -1 pages where the plain version reads the trash
    page, which differs where a hole lies below a slot's position."""
    b, _, h, d = q.shape
    k, v = pa.gather_pages(f32, tab, kv_heads=kv_heads, max_pages=max_pages,
                           dtype=torch.float32)
    ps = k.shape[1] // max_pages
    held = (tab[:, :max_pages] >= 0).repeat_interleave(ps, dim=1)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = held & (kpos[None, :] <= pos[:, None])
    if window:
        mask = mask & (kpos[None, :] > pos[:, None] - window)
    s = torch.einsum("bkgd,bskd->bkgs",
                     q.float().reshape(b, kv_heads, h // kv_heads, d),
                     k.float()) * scale
    s = torch.where(mask[:, None, None, :], s, -1e30)
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), v.float())
    return out.reshape(b, 1, h, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("name,ps,lens,holes,window", [
    # B 1 at position 2047: the walk split over 64 blocks
    ("b1-2047", 16, (2048,), (), 0),
    ("page4", 4, (2048, 0, 700), (), 0),
    ("page8", 8, (2048, 1201, 0), (), 0),
    ("page32", 32, (2048, 0, 33), (), 0),
    # slot 0's columns 20..59 unassigned: whole splits see only -1
    ("holes", 16, (2048, 0), tuple(range(20, 60)), 0),
    # a window of 100 keys at 2047 leaves every split but the last empty
    ("window", 16, (2048, 1500, 0), (), 100)])
def test_split_decode_matches_plain(dev, dtype, mode, name, ps, lens, holes,
                                    window):
    rnd, layer, tab, f32, width = _split_case(
        dev, mode=mode, dtype=dtype, ps=ps, lens=lens, holes=holes,
        seed=ps + len(lens))
    b = len(lens)
    pos = torch.as_tensor(np.maximum(np.asarray(lens) - 1, 0),
                          dtype=torch.int32, device=dev)
    q = rnd(b, 1, 8, 128)
    kw = dict(scale=128 ** -0.5, window=window, kv_heads=2,
              max_pages=width)
    assert pa.plan_splits(b, 2, 1, width, ps, torch.cuda.get_device_properties(
        dev).multi_processor_count) > 1
    pa.reset_launches()
    out = pa.paged_attention(q, layer, tab, pos, **kw)
    again = pa.paged_attention(q, layer, tab, pos, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == {"decode": 2, "chunk": 0, "verify": 0}
    assert torch.equal(out, again)  # bitwise, whichever split ends last
    active = torch.as_tensor(np.asarray(lens) > 0, device=dev)
    if holes:  # held below the position: the plain version reads trash
        ref = _held_keys_plain(q, layer if dtype == torch.float32 else f32,
                               tab, pos, **kw)
    else:
        ref = _split_plain(q, layer, f32, tab, pos, **kw)
    rtol, atol = _TOL[dtype]
    torch.testing.assert_close(out[active].float(), ref[active].float(),
                               rtol=rtol, atol=atol)
    assert torch.all(out[~active] == 0)  # a free slot: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("name,c,lens,max_pages,window", [
    # B 1, a spec_k=4 chunk at the end of the context
    ("b1-end", 5, (2048,), None, 0),
    # no committed page walked: the in-flight rows alone
    ("w0", 5, (300, 0), 0, 0),
    # 17 rows x 4 heads = 68 query rows: three row tiles
    ("rows68", 17, (1900, 0, 640), None, 0),
    ("window", 5, (2048, 777), None, 64)])
def test_split_verify_matches_plain(dev, dtype, mode, name, c, lens,
                                    max_pages, window):
    """Cells from each chunk's start on hold other rows (stale rows), which
    only the kpos < start mask hides; a free slot (start 0, no pages) sees
    its in-flight rows only."""
    rnd, layer, tab, f32, width = _split_case(
        dev, mode=mode, dtype=dtype, ps=16, lens=lens, seed=c + len(lens))
    b = len(lens)
    start = np.maximum(np.asarray(lens) - c - 3, 0)
    pos = torch.as_tensor(start[:, None] + np.arange(c)[None, :],
                          dtype=torch.int32, device=dev)
    q = rnd(b, c, 8, 128)
    ek, ev = rnd(b, c, 2, 128), rnd(b, c, 2, 128)
    kw = dict(scale=128 ** -0.5, window=window, kv_heads=2,
              max_pages=width if max_pages is None else max_pages,
              variant="verify", extra_k=ek, extra_v=ev)
    pa.reset_launches()
    out = pa.paged_attention(q, layer, tab, pos, **kw)
    again = pa.paged_attention(q, layer, tab, pos, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == {"decode": 0, "chunk": 0, "verify": 2}
    assert torch.equal(out, again)
    ref = _split_plain(q, layer, f32, tab, pos, **kw)
    rtol, atol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


def test_verify_chunk_paged_on_card_matches_cpu(dev):
    """The tiny f32 model's verify step: logits and chunk rows on the
    card (kernel) equal the CPU's (plain version) to 1e-4, one verify
    launch per layer, and the pools are not written."""
    cfg = get_config("tiny", n_layer=2, d_model=128, n_head=4, n_kv_head=2,
                     d_ff=256, vocab_size=128, max_seq=64, dtype="float32")
    geom = kvc.make_geometry(cfg, n_slots=3, max_len=64, page_size=16,
                             mode="int8")
    g = torch.Generator().manual_seed(0)
    pools = kvc.init_pools(geom, "cpu")
    for name in ("k", "v"):
        x = torch.randn((2, geom.n_pages, 16, geom.row_elems), generator=g)
        qv, sc = quant.kv_encode_rows(x, geom.kv_block)
        pools[name + "_q"].copy_(qv)
        pools[name + "_scale"].copy_(sc)
    tab = torch.arange(1, geom.n_pages, dtype=torch.int32).reshape(3, -1)
    tokens = torch.randint(0, 128, (3, 5), generator=g)
    start = torch.tensor([40, 3, 0], dtype=torch.int32)
    model = decoder.init(cfg, seed=0, device="cpu")
    got = {}
    for where in ("cpu", "cuda"):
        p = {k: v.to(where) for k, v in pools.items()}
        pa.reset_launches()
        got[where] = [x.cpu() for x in model.to(where).verify_chunk_paged(
            tokens.to(where), p, tab.to(where), start.to(where))]
        for k, v in p.items():
            assert torch.equal(v.cpu(), pools[k])
    assert pa.LAUNCHES == {"decode": 0, "chunk": 0, "verify": 2}
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_kernel_takes_a_block_table_row_view(dev):
    """One slot's row of a block table whose width is not a multiple of
    4 (max_len 2000 at page 16 gives 125 columns) starts on a 4-byte,
    not a 16-byte, boundary: the kernel reads it as it is."""
    q, pools, tab, pos, kw, _ = _case(
        dev, mode="int8", dtype=torch.bfloat16, hkv=2, groups=4, d=128,
        ps=16, c=1, lens=[40, 9, 100], window=0, seed=2)
    wide = torch.cat([tab, torch.full_like(tab[:, :1], -1)], 1)
    full = pa.paged_attention(q, pools, tab, pos, **kw)
    assert wide[1:2].data_ptr() % 16
    for i in range(3):
        out = pa.paged_attention(q[i:i + 1], pools, wide[i:i + 1],
                                 pos[i:i + 1], **kw)
        assert torch.equal(out, full[i:i + 1])


def test_spec_and_sharing_engine_on_card_matches_cpu_streams(dev):
    """Greedy streams of the tiny f32 model with spec_k=3 and prefix
    sharing (two prompts share 20 tokens; 5 pages a slot, so a slot's
    table row starts mid-vector): the card and the CPU agree token for
    token, and the card ran the verify kernel."""
    from dlrover_tpu_torch.serving.server import GenerationServer

    cfg = get_config("tiny", n_layer=2, d_model=128, n_head=4, n_kv_head=2,
                     d_ff=256, vocab_size=128, max_seq=128, dtype="float32")
    rng = np.random.default_rng(1)
    shared = list(map(int, rng.integers(1, 128, size=20)))
    prompts = [shared + [5, 6, 5, 6, 5], shared + [7, 7, 7],
               [3, 4, 3, 4, 3, 4, 3]]
    outs = {}
    for where in ("cpu", "cuda"):
        model = decoder.init(cfg, seed=0, device="cpu").to(where)
        server = GenerationServer(model, cfg, device=where, n_slots=3,
                                  max_len=80, page_size=16, mode="int8",
                                  prefill_chunk=8, spec_k=3,
                                  prefix_sharing=True).start()
        pa.reset_launches()
        try:
            # the others arrive while the first still holds its pages
            first = server.submit(prompts[0], 30)
            while not (first.first_token_t or first.future.done()):
                time.sleep(0.001)
            rest = [server.submit(p, 12) for p in prompts[1:]]
            outs[where] = [r.future.result(timeout=120)
                           for r in [first] + rest]
        finally:
            server.stop()
        stats = server.engine.stats()
        assert stats["prefix_hits"] >= 1 and stats["draft_tokens"] > 0
        if where == "cuda":
            assert pa.LAUNCHES["verify"] > 0
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# flash attention and the fused norm
# ---------------------------------------------------------------------------


def _normwise(out, ref, tol):
    scale = float(ref.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d,causal,window", [
    (2, 256, 4, 4, 128, True, 0), (2, 256, 4, 2, 64, True, 0),
    (1, 300, 4, 1, 128, False, 0), (2, 200, 2, 2, 64, True, 33),
    (1, 129, 8, 2, 128, True, 0)])
def test_flash_kernels_match_plain(dev, dtype, b, s, h, hkv, d, causal,
                                   window):
    from dlrover_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v, go = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, s, h, d), (b, s, hkv, d),
                                 (b, s, hkv, d), (b, s, h, d)))
    kw = dict(causal=causal, scale=d ** -0.5, window=window)
    fa.reset_launches()
    out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    delta = (go.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = fa.flash_bwd_cuda(q, k, v, go, lse, delta, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {k: int(k in fa.UNPACKED) for k in fa.KERNELS}
    f = [x.float() for x in (q, k, v)]
    ref, ref_lse = fa.flash_fwd_reference(*f, **kw)
    refs = fa.flash_bwd_reference(*f, out.float(), lse, go.float(), **kw)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    _normwise(out, ref, tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    for got, want in zip((dq, dk, dv), refs):
        _normwise(got, want, tol)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d,window,offsets,prefix", [
    # a ring block the window edge crosses: GQA at D 128 and D 64
    (1, 512, 8, 2, 128, 700, (1536, 1024), None),
    (1, 300, 4, 2, 64, 333, (900, 600), None),
    # a prefix-only block (packed): prefixes 0, inside and past the block
    (3, 256, 4, 4, 64, 0, (-(1 << 30), 0), (0, 100, 256)),
    # a prefix-only block of the one-head kernels (D 128)
    (2, 200, 4, 2, 128, 0, (-(1 << 30), 0), (77, 0))])
def test_flash_kernels_take_ring_offsets(dev, dtype, b, s, h, hkv, d, window,
                                         offsets, prefix):
    """Every flash kernel with ring offsets against the plain versions on
    the rows that see a key; a row that sees none ends with an lse at or
    below -1e27 (the ring merge's NEG_INF guard drops it), and its
    cotangent is zero, as the ring router leaves it."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(s + d + b)
    q, k, v, go = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, s, h, d), (b, s, hkv, d),
                                 (b, s, hkv, d), (b, s, h, d)))
    pref = (None if prefix is None
            else torch.tensor(prefix, dtype=torch.int32, device=dev))
    pack = fa.head_pack_for(h, hkv, d)
    kw = dict(causal=True, scale=d ** -0.5, window=window)
    seen = fa._allowed(s, s, True, window, pref, offsets, dev).any(-1)
    go = torch.where(seen[:, :, None, None], go, 0).to(dtype)
    fa.reset_launches()
    out, lse = fa.flash_fwd_cuda(q, k, v, prefix=pref, pack=pack,
                                 offsets=offsets, **kw)
    delta = (go.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = fa.flash_bwd_cuda(q, k, v, go, lse, delta, prefix=pref,
                                   pack=pack, offsets=offsets, **kw)
    torch.cuda.synchronize()
    names = fa.PACKED if pack == 2 else fa.UNPACKED
    assert fa.OFFSET_LAUNCHES == {n: int(n in names) for n in fa.KERNELS}
    f = [x.float() for x in (q, k, v)]
    ref, ref_lse = fa.flash_fwd_reference(*f, prefix=pref, offsets=offsets,
                                          **kw)
    refs = fa.flash_bwd_reference(*f, out.float(), lse, go.float(),
                                  prefix=pref, offsets=offsets, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    rows = seen.expand(b, s)
    _normwise(out[rows], ref[rows], tol)
    lse_t = lse.transpose(1, 2)
    torch.testing.assert_close(lse_t[rows], ref_lse.transpose(1, 2)[rows],
                               rtol=1e-5, atol=1e-5)
    assert bool((lse_t[~rows] <= -1e27).all())
    assert bool(torch.isfinite(out.float()).all())
    for got, want in zip((dq, dk, dv), refs):
        _normwise(got, want, tol)
    # the fault the gates must catch: k_off off by one key (a prefix-only
    # block's q_off, at the kernels' range, moves with it)
    bad, _ = fa.flash_fwd_cuda(
        q, k, v, prefix=pref, pack=pack,
        offsets=(offsets[0] + (offsets[0] < 0), offsets[1] + 1), **kw)
    err = float((bad.float() - ref)[rows].abs().max())
    assert err > tol * float(ref[rows].abs().max())

def test_flash_autograd_on_card_matches_cpu(dev):
    from dlrover_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v, go = (torch.randn(shape, generator=g) for shape in (
        (2, 160, 4, 64), (2, 160, 2, 64), (2, 160, 2, 64), (2, 160, 4, 64)))
    grads = {}
    for where in ("cpu", "cuda"):
        leaves = [x.to(where).detach().requires_grad_() for x in (q, k, v)]
        out, lse = fa.flash_attention_with_lse(*leaves, window=50)
        ((out * go.to(where)).sum() + lse.sum()).backward()
        grads[where] = [out.detach().cpu()] + [x.grad.cpu() for x in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _normwise(a, b, 1e-4)


def test_flash_cuda_raises_for_what_the_kernel_does_not_take(dev):
    from dlrover_tpu_torch.ops import flash_attention as fa

    q = torch.randn(1, 64, 2, 64, device=dev)
    with pytest.raises(ValueError, match="int32 range"):
        fa.flash_attention_with_lse(
            q, q, q, offsets=torch.tensor([-(1 << 30), 1], device=dev))
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.randn(1, 64, 2, 32, device=dev)
        fa.flash_attention(x, x, x, head_pack=1)
    with pytest.raises(ValueError, match="packs 4"):
        x = torch.randn(1, 64, 4, 32, device=dev)
        fa.flash_attention(x, x, x)  # auto: 4 heads of 32 a block


def _flash_case(dev, dtype, b, s, h, hkv, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, h, d))]


def _check_flash(fa, q, k, v, go, out, lse, grads, kw, prefix, tol):
    f = [x.float() for x in (q, k, v)]
    ref, ref_lse = fa.flash_fwd_reference(*f, prefix=prefix, **kw)
    refs = fa.flash_bwd_reference(*f, out.float(), lse, go.float(),
                                  prefix=prefix, **kw)
    _normwise(out, ref, tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    for got, want in zip(grads, refs):
        _normwise(got, want, tol)


def _record_bwd_ids(fa, monkeypatch):
    """The backward kernel ids the C entry is given, in call order."""
    lib = fa._lib()
    real, ids = lib["bwd"], []

    def bwd(*args):
        ids.append(args[0])
        return real(*args)

    monkeypatch.setitem(lib, "bwd", bwd)
    return ids


def _packed_bwd_ids(fa, dtype):
    """bf16: the packed pair on wgmma; f32: the mma.sync pair."""
    want = (("flash_bwd_dq_packed_wgmma_kernel",
             "flash_bwd_dkv_packed_wgmma_kernel") if dtype == torch.bfloat16
            else ("flash_bwd_dq_packed_kernel", "flash_bwd_dkv_packed_kernel"))
    assert fa.bwd_cuda_kernel(dtype, 2) == want
    return [fa.BWD_CUDA_KERNELS.index(n) for n in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,causal,prefix", [
    # an odd head count: the last block holds one head
    (2, 256, 5, True, None), (1, 300, 3, False, None),
    # a prefix per sequence: none, mid-tile, past the end
    (3, 200, 4, True, (0, 150, 500)), (2, 129, 7, True, (64, 1)),
    # one head (a single ragged pack); gpt2-1.5b's 25 heads at S 1024
    (2, 127, 1, True, None), (2, 1024, 25, True, None),
    # q tiles of 64 and key tiles of 128 both ragged
    (2, 129, 2, True, None), (1, 1000, 3, True, None),
    (2, 1000, 5, False, None),
    # glm-10b's 64 heads with prefixes of none, mid-tile and past the end
    (3, 256, 64, True, (0, 100, 400))])
def test_packed_flash_kernels_match_plain(dev, monkeypatch, dtype, b, s, h,
                                          causal, prefix):
    from dlrover_tpu_torch.ops import flash_attention as fa

    ids = _record_bwd_ids(fa, monkeypatch)
    q, k, v, go = _flash_case(dev, dtype, b, s, h, h, 64, s + h)
    pref = (None if prefix is None
            else torch.tensor(prefix, dtype=torch.int32, device=dev))
    kw = dict(causal=causal, scale=0.125, window=0)
    fa.reset_launches()
    out, lse = fa.flash_fwd_cuda(q, k, v, prefix=pref, pack=2, **kw)
    delta = (go.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    grads = fa.flash_bwd_cuda(q, k, v, go, lse, delta, prefix=pref, pack=2,
                              **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {k: int(k in fa.PACKED) for k in fa.KERNELS}
    assert ids == _packed_bwd_ids(fa, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    _check_flash(fa, q, k, v, go, out, lse, grads, kw, pref, tol)
    # the packed and the unpacked kernels compute the same function
    out1, lse1 = fa.flash_fwd_cuda(q, k, v, prefix=pref, **kw)
    _normwise(out, out1, tol)
    torch.testing.assert_close(lse, lse1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_flash_forward_takes_a_window(dev, monkeypatch, dtype):
    """A sliding window in the packed forward (its key range a row) and
    the packed backward, odd H, ragged S."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    ids = _record_bwd_ids(fa, monkeypatch)
    q, k, v, go = _flash_case(dev, dtype, 2, 300, 5, 5, 64, 11)
    kw = dict(causal=True, scale=0.125, window=50)
    out, lse = fa.flash_fwd_cuda(q, k, v, pack=2, **kw)
    delta = (go.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    grads = fa.flash_bwd_cuda(q, k, v, go, lse, delta, pack=2, **kw)
    torch.cuda.synchronize()
    assert ids == _packed_bwd_ids(fa, dtype)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    _check_flash(fa, q, k, v, go, out, lse, grads, kw, None, tol)


@pytest.mark.parametrize("b,s,h,prefix", [
    # gpt2-1.5b's 25 heads (a ragged last pack) at a ragged S; glm-10b's
    # 64 heads with prefixes of none, mid-tile and past the end
    (2, 1001, 25, None), (3, 512, 64, (0, 200, 600))])
def test_packed_flash_bwd_repeats_and_matches_unpacked(dev, b, s, h,
                                                       prefix):
    """The bf16 packed backward pair (persistent, items from a counter)
    repeats bit for bit, and equals the unpacked D 64 pair on the same
    out and lse within the bf16 kernels' tolerance (2^-6 of the largest
    |value|): the same arithmetic on other blocks."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    q, k, v, go = _flash_case(dev, torch.bfloat16, b, s, h, h, 64, s + h)
    pref = (None if prefix is None
            else torch.tensor(prefix, dtype=torch.int32, device=dev))
    kw = dict(causal=True, scale=0.125, window=0, prefix=pref)
    out, lse = fa.flash_fwd_cuda(q, k, v, pack=2, **kw)
    delta = (go.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    first = fa.flash_bwd_cuda(q, k, v, go, lse, delta, pack=2, **kw)
    second = fa.flash_bwd_cuda(q, k, v, go, lse, delta, pack=2, **kw)
    unpacked = fa.flash_bwd_cuda(q, k, v, go, lse, delta, pack=1, **kw)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    for a, u in zip(first, unpacked):
        assert bool(torch.isfinite(a.float()).all())
        _normwise(a, u, 2.0 ** -6)


def test_packed_bf16_forward_runs_on_the_core(dev, monkeypatch):
    """A bf16 pack-2 forward launches flash_fwd_packed_wgmma_kernel (the
    id the C entry gets), counts under flash_fwd_packed, repeats bit for
    bit, and its heads equal the zero-padded call's (the ragged pack)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    lib = fa._lib()
    real, ids = lib["fwd"], []

    def fwd(*args):
        ids.append(args[15])
        return real(*args)

    monkeypatch.setitem(lib, "fwd", fwd)
    q, k, v, _ = _flash_case(dev, torch.bfloat16, 3, 1000, 25, 25, 64, 7)
    pref = torch.tensor([0, 333, 2000], dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=0.125, window=0, prefix=pref)
    fa.reset_launches()
    first = fa.flash_fwd_cuda(q, k, v, pack=2, **kw)
    second = fa.flash_fwd_cuda(q, k, v, pack=2, **kw)
    padded = fa.flash_fwd_cuda(*(torch.cat(
        [x, torch.zeros_like(x[:, :, :1])], 2).contiguous()
        for x in (q, k, v)), pack=2, **kw)
    torch.cuda.synchronize()
    assert ids == [fa.FWD_CUDA_KERNELS.index(
        "flash_fwd_packed_wgmma_kernel")] * 3
    assert fa.LAUNCHES == {n: 3 * (n == "flash_fwd_packed")
                           for n in fa.KERNELS}
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(first[0], padded[0][:, :, :25])
    assert torch.equal(first[1], padded[1][:, :25])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,d", [(4, 128), (2, 64)])
def test_unpacked_flash_kernels_take_the_prefix(dev, dtype, hkv, d):
    from dlrover_tpu_torch.ops import flash_attention as fa

    q, k, v, go = _flash_case(dev, dtype, 3, 160, 4, hkv, d, d + hkv)
    pref = torch.tensor([0, 70, 999], dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=d ** -0.5, window=0)
    out, lse = fa.flash_fwd_cuda(q, k, v, prefix=pref, **kw)
    delta = (go.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    grads = fa.flash_bwd_cuda(q, k, v, go, lse, delta, prefix=pref, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    _check_flash(fa, q, k, v, go, out, lse, grads, kw, pref, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,d", [(37, 96), (512, 2048), (1, 2048),
                                 (3, 1600), (263, 4096)])
def test_norm_kernels_match_plain(dev, dtype, kind, residual, n, d):
    """Also a row, and row counts below the backward's grid that its rows
    a block do not divide."""
    _norm_case(dev, dtype, kind, residual, n, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,d", [(70, 1600), (45, 4096)] + [
    (n, d) for d in (8, 136, 1600, 2048, 4096)
    for n in (1, 7, 8193, 3, 263)])
def test_norm_kernels_at_gpt2_and_glm_widths(dev, dtype, residual, n, d):
    """Layernorm with bias at gpt2-1.5b's d 1600 (200 vectors a row, not
    a multiple of 32 lanes) and glm-10b's 4096 (a row over 8 warps; f32
    rows of 4 vectors a lane in the backward), and at the plans' edges:
    one vector a row (d 8), 17 (d 136), a row over 2, 4 and 8 warps (d
    1600 to 4096), and row counts no block's rows divide (1, 3, 7, 263,
    8193), below the grid and past it, so the persistent grids' last rows
    and their smallest grids run."""
    _norm_case(dev, dtype, "layernorm", residual, n, d)


@pytest.mark.parametrize("kind,d", [("layernorm", 4096),
                                    ("rmsnorm", 2048)])
@pytest.mark.parametrize("residual", [False, True])
def test_norm_backward_repeats_bit_for_bit(dev, kind, d, residual):
    """dx, dscale and dbias of the norm backward are equal bit for bit on a
    repeated call at glm-10b's d 4096 with a bias and llama-1.4b's d 2048:
    rows go to groups by a fixed stride, the column sums are added in a
    fixed order, no atomics."""
    from dlrover_tpu_torch.ops import norm as nm

    g = torch.Generator(device=dev).manual_seed(d)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    n = 8192
    go, h = rnd(n, d), rnd(n, d)
    gh = rnd(n, d) if residual else None
    scale = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
    eps = nm.RMS_EPS if kind == "rmsnorm" else nm.LN_EPS
    bias = kind == "layernorm"
    first = nm.norm_bwd_cuda(go, h, scale, gh, kind, eps, bias)
    second = nm.norm_bwd_cuda(go, h, scale, gh, kind, eps, bias)
    torch.cuda.synchronize()
    assert (first[2] is None) == (not bias)
    for a, b in zip(first, second):
        if a is not None:
            assert torch.equal(a, b)
            assert bool(torch.isfinite(a.float()).all())


def _norm_case(dev, dtype, kind, residual, n, d):
    from dlrover_tpu_torch.ops import norm as nm

    g = torch.Generator(device=dev).manual_seed(n + d)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    x, go = rnd(n, d), rnd(n, d)
    res = rnd(n, d) if residual else None
    gh = rnd(n, d) if residual else None
    scale = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
    bias = 0.1 * torch.randn(d, generator=g, device=dev) \
        if kind == "layernorm" else None
    eps = nm.RMS_EPS if kind == "rmsnorm" else nm.LN_EPS
    nm.reset_launches()
    out, h = nm.norm_fwd_cuda(x, scale, bias, res, kind, eps)
    dx, ds, db = nm.norm_bwd_cuda(go, h, scale, gh, kind, eps,
                                  bias is not None)
    torch.cuda.synchronize()
    assert nm.LAUNCHES == {"norm_fwd": 1, "norm_bwd": 1}
    h_ref = x + res if residual else x
    assert torch.equal(h, h_ref)
    ref = nm._reference(h_ref.float(), scale, bias, kind, eps, None)
    rdx, rds, rdb = nm.norm_bwd_reference(
        go.float(), h_ref.float(), scale, None if gh is None else gh.float(),
        kind, eps, bias is not None)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    _normwise(out, ref, tol)
    _normwise(dx, rdx, tol)
    _normwise(ds, rds, 1e-4)
    if bias is not None:
        _normwise(db, rdb, 1e-4)


def test_train_step_on_card_matches_cpu_and_counts_launches(dev):
    """A tiny f32 model: the loss stream of three steps on the card
    (kernels) equals the CPU's (plain versions) to 1e-4, and each step
    launches each flash kernel once per layer and each norm kernel
    2·layers + 1 times."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import norm as nm
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    # head_dim 64: the flash kernels take 64 and 128
    cfg = get_config("tiny", n_layer=2, d_model=128, n_head=2, n_kv_head=1,
                     d_ff=256, vocab_size=512, max_seq=64, dtype="float32",
                     tie_embeddings=False)
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, 512, size=(4, 65)))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    losses = {}
    for where in ("cpu", "cuda"):
        tx = make_optimizer(learning_rate=1e-3, warmup_steps=1,
                            decay_steps=20)
        state = init_train_state(0, cfg, tx, device="cpu")
        state["params"].to(where)
        state["opt_state"] = tx.init(dict(state["params"].named_parameters()))
        step = TrainStepBuilder(cfg, tx, device=where).build()
        fa.reset_launches()
        nm.reset_launches()
        losses[where] = [float(step(state, batch)[1]["loss"])
                         for _ in range(3)]
        if where == "cuda":
            assert fa.LAUNCHES == {k: 3 * 2 * (k in fa.UNPACKED)
                                   for k in fa.KERNELS}
            assert nm.LAUNCHES == {k: 3 * 5 for k in nm.KERNELS}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("kind", ["gpt2", "glm"])
def test_packed_train_step_on_card_matches_cpu(dev, kind):
    """Tiny f32 models of the packed families (5 heads of 64, learned
    positions, tied head; 2 heads of 64, rope, prefix-LM): three steps on
    the card equal the CPU's to 1e-4, each step launching each packed
    flash kernel once a layer and no unpacked one."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    over = dict(norm="layernorm", act="gelu", tie_embeddings=True,
                n_layer=2, vocab_size=512, max_seq=64, dtype="float32")
    if kind == "gpt2":
        over.update(d_model=320, n_head=5, d_ff=640, pos="learned")
    else:
        over.update(d_model=128, n_head=2, d_ff=512, pos="rope",
                    prefix_lm=True)
    cfg = get_config("tiny", **over)
    rng = np.random.default_rng(1)
    tok = torch.as_tensor(rng.integers(0, 512, size=(4, 65)))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if kind == "glm":
        batch["prefix_len"] = torch.tensor([0, 9, 40, 64], dtype=torch.int32)
    losses = {}
    for where in ("cpu", "cuda"):
        tx = make_optimizer(learning_rate=1e-3, warmup_steps=1,
                            decay_steps=20)
        state = init_train_state(0, cfg, tx, device="cpu")
        state["params"].to(where)
        state["opt_state"] = tx.init(dict(state["params"].named_parameters()))
        step = TrainStepBuilder(cfg, tx, device=where).build()
        fa.reset_launches()
        losses[where] = [float(step(state, batch)[1]["loss"])
                         for _ in range(3)]
        if where == "cuda":
            assert fa.LAUNCHES == {k: 3 * 2 * (k in fa.PACKED)
                                   for k in fa.KERNELS}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the two kernels on the tensor-core core (csrc/attn_fwd_core.cuh)
# ---------------------------------------------------------------------------


def _chunk_tc_case(dev, mode, d, starts, c, held, seed, ps=16):
    """llama3-8b's head grouping (4 query heads a KV head) at 2 KV heads,
    pages of ``ps`` (llama3-8b's 16 by default): slot i's chunk of C
    queries at starts[i], holding held[i] tokens' pages in a shuffled
    order (0: a free slot; past the chunk: pages beyond the last position,
    -1 columns after them)."""
    cfg = get_config("tiny", n_head=8, n_kv_head=2, d_model=8 * d,
                     n_layer=1, dtype="bfloat16")
    b = len(starts)
    geom = kvc.make_geometry(cfg, n_slots=b, max_len=2048, page_size=ps,
                             mode=mode)
    g = torch.Generator(device=dev).manual_seed(seed)
    pools = kvc.init_pools(geom, dev)
    for name in ("k", "v"):
        x = torch.randn((1, geom.n_pages, ps, geom.row_elems), generator=g,
                        device=dev)
        if mode == "bf16":
            pools[name].copy_(x.reshape(pools[name].shape))
        else:
            qv, sc = quant.kv_encode_rows(x, geom.kv_block)
            pools[name + "_q"].copy_(qv)
            pools[name + "_scale"].copy_(sc)
    rng = np.random.default_rng(seed)
    tab = chip_smoke._fragmented_tables(b, geom.max_pages_per_slot, held, ps,
                                        rng)
    pos = torch.as_tensor(np.asarray(starts)[:, None] + np.arange(c),
                          dtype=torch.int32, device=dev)
    q = torch.randn((b, c, 8, d), generator=g, device=dev).to(torch.bfloat16)
    pools = kvc.layer_pools(pools, 0)
    return (q, pools, torch.as_tensor(tab, device=dev), pos,
            torch.as_tensor(np.asarray(held) > 0, device=dev))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("starts,c,held,window,ps", [
    ((1536,), 256, (1792,), 0, 16),
    ((1536,), 256, (1792,), 512, 16),
    # ragged: 800 rows, the last tile 32
    ((1536,), 200, (1736,), 0, 16),
    # B 2; a free slot; pages held past the last position
    ((1536, 700), 256, (1792, 956), 0, 16),
    ((300, 0, 41), 200, (500, 0, 241 + 70), 0, 16),
    # pages of 8 and 32: a 64-key tile spans 8 or 2 pages held out of
    # order (8: not 64-key aligned past a window edge either)
    ((1536,), 256, (1792,), 0, 8),
    ((1536, 700), 256, (1792, 956), 300, 8),
    ((300, 0, 41), 200, (500, 0, 241 + 70), 0, 8),
    ((1536,), 256, (1792,), 0, 32),
    ((1536, 700), 256, (1792, 956), 300, 32),
    ((300, 0, 41), 200, (500, 0, 241 + 70), 0, 32)])
def test_chunk_kernel_on_the_tensor_cores(dev, mode, d, starts, c, held,
                                          window, ps):
    q, pools, tab, pos, active = _chunk_tc_case(
        dev, mode, d, starts, c, held, seed=d + c + len(starts), ps=ps)
    kw = dict(scale=d ** -0.5, window=window, kv_heads=2, variant="chunk")
    pa.reset_launches()
    out = pa.paged_attention(q, pools, tab, pos, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == {"decode": 0, "chunk": 1, "verify": 0}
    assert pa.cuda_kernel("chunk", q.dtype, d) == "paged_chunk_wgmma_kernel"
    ref, bound = chip_smoke.chunk_bound(q, _read_f32(pools, 2, d), tab, pos,
                                        **kw)
    err, over, ratio = chip_smoke._held(out, ref, active, bound)
    assert over == 0, (err, ratio)
    assert torch.all(out[~active] == 0)  # a free slot: exact zeros
    assert torch.isfinite(out.float()).all()
    # a one-slot row view of a table whose width is not a multiple of 4:
    # equal to the batch call's slot bit for bit where both split the walk
    # alike (the split count follows the launch shape), else under the
    # bound as well
    wide = torch.cat([tab, torch.full_like(tab[:, :1], -1)], 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-c * 4 // pa.SPLIT_ROWS["chunk"])
    split_b = pa.plan_chunk_splits(len(starts), 2, tiles, tab.shape[1], ps,
                                   sms)
    for i in range(len(starts)):
        one = pa.paged_attention(q[i:i + 1], pools, wide[i:i + 1],
                                 pos[i:i + 1], **kw)
        if pa.plan_chunk_splits(1, 2, tiles, wide.shape[1], ps,
                                sms) == split_b:
            assert torch.equal(one, out[i:i + 1])
        if bool(active[i]):
            assert chip_smoke._held(one, ref[i:i + 1], active[i:i + 1],
                                    bound[i:i + 1])[1] == 0
        else:
            assert torch.all(one == 0)


_TC_FLASH_CASES = [
    ("d128", 2, 256, 4, 4, 128, True, 0, None),
    ("d64-gqa", 2, 256, 4, 2, 64, True, 0, None),
    ("noncausal-gqa", 1, 300, 4, 1, 128, False, 0, None),
    ("s1000", 2, 1000, 8, 2, 128, True, 0, None),
    ("s1000-d64-noncausal", 2, 1000, 4, 4, 64, False, 0, None),
    ("window", 2, 512, 4, 4, 128, True, 100, None),
    ("window-d64", 2, 1000, 4, 2, 64, True, 257, None),
    # a prefix per sequence: none, mid-tile, past the end
    ("prefix", 3, 400, 4, 2, 128, True, 0, (0, 150, 500)),
    ("prefix-d64", 3, 1000, 4, 4, 64, True, 0, (0, 517, 1000))]


@pytest.mark.parametrize("name,b,s,h,hkv,d,causal,window,prefix",
                         _TC_FLASH_CASES)
def test_flash_fwd_on_the_tensor_cores(dev, name, b, s, h, hkv, d, causal,
                                       window, prefix):
    """The bf16 one-head forward (flash_fwd_wgmma_kernel) against
    flash_fwd_reference element by element, and the backward kernels on
    its out and lse, each under chip_smoke.py's flash bounds with a
    planted fault caught (a key row replaced; the prefix shifted by one
    key)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    assert fa.fwd_cuda_kernel(torch.bfloat16, 1) == "flash_fwd_wgmma_kernel"
    gen = torch.Generator(device=dev).manual_seed(s + d + h)
    fa.reset_launches()
    rec = chip_smoke.flash_case(name, b, s, h, hkv, d, causal, window, gen,
                                dev, False, prefix=prefix,
                                fault="key" if prefix is None else "prefix")
    assert rec["ok"], rec
    assert fa.LAUNCHES["flash_fwd"] == 2
    assert fa.LAUNCHES["flash_fwd_packed"] == 0


@pytest.mark.parametrize("name,b,s,h,hkv,d,causal,window,prefix,sk", [
    case + (None,) for case in _TC_FLASH_CASES] + [
    # GQA groups of 4 and 8 (the dkv kernel's ring runs on from one query
    # head of the group to the next)
    ("gqa4", 2, 512, 16, 4, 128, True, 0, None, None),
    ("gqa8-d64", 2, 512, 16, 2, 64, True, 0, None, None),
    ("gqa8-window", 1, 1001, 8, 1, 128, True, 100, None, None),
    # lse rows of S * 4 bytes, not a multiple of 16
    ("s257", 2, 257, 4, 4, 128, True, 0, None, None),
    ("s1001-d64", 2, 1001, 4, 2, 64, True, 0, None, None),
    ("prefix-s1001", 3, 1001, 4, 4, 128, True, 0, (0, 517, 1100), None),
    # Sq != Sk
    ("noncausal-sq<sk", 2, 257, 4, 2, 128, False, 0, None, 1001),
    ("noncausal-sq>sk-d64", 2, 1001, 4, 4, 64, False, 0, None, 257),
    ("causal-sq<sk", 1, 300, 4, 2, 128, True, 0, None, 1001),
    # a window wider than S
    ("window>s", 2, 300, 4, 4, 128, True, 1000, None, None)])
def test_flash_bwd_on_the_tensor_cores(dev, monkeypatch, name, b, s, h, hkv,
                                       d, causal, window, prefix, sk):
    """The bf16 backward of one head a block (flash_bwd_dq_wgmma_kernel,
    flash_bwd_dkv_wgmma_kernel) on the forward kernel's out and lse,
    through chip_smoke.flash_case: dq, dk and dv under chip_smoke.py's
    flash bounds element by element, with a planted fault caught (a key
    row replaced; the prefix shifted by one key), and the kernel ids the
    C entry was given."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    lib = fa._lib()
    real, ids = lib["bwd"], []

    def bwd(*args):
        ids.append(args[0])
        return real(*args)

    monkeypatch.setitem(lib, "bwd", bwd)
    gen = torch.Generator(device=dev).manual_seed(s + d + h)
    fa.reset_launches()
    rec = chip_smoke.flash_case(name, b, s, h, hkv, d, causal, window, gen,
                                dev, False, prefix=prefix, sk=sk,
                                fault="key" if prefix is None else "prefix")
    assert rec["ok"], rec
    pair = [fa.BWD_CUDA_KERNELS.index(n)
            for n in fa.bwd_cuda_kernel(torch.bfloat16, 1)]
    assert pair == [fa.BWD_CUDA_KERNELS.index("flash_bwd_dq_wgmma_kernel"),
                    fa.BWD_CUDA_KERNELS.index("flash_bwd_dkv_wgmma_kernel")]
    assert ids == pair * 2  # the checked run and the faulted run
    assert fa.LAUNCHES["flash_bwd_dq"] == fa.LAUNCHES["flash_bwd_dkv"] == 2
    assert fa.LAUNCHES["flash_bwd_dq_packed"] == 0


@pytest.mark.parametrize("hkv,d,window", [(2, 128, 0), (16, 64, 300)])
def test_flash_bwd_repeats_bit_for_bit(dev, hkv, d, window):
    """dq, dk and dv of the bf16 backward pair are equal bit for bit on a
    repeated call: no atomics, the GQA group summed in a fixed order."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    q, k, v, go = _flash_case(dev, torch.bfloat16, 2, 1001, 16, hkv, d, 5)
    kw = dict(causal=True, scale=d ** -0.5, window=window)
    out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    delta = (go.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    first = fa.flash_bwd_cuda(q, k, v, go, lse, delta, **kw)
    second = fa.flash_bwd_cuda(q, k, v, go, lse, delta, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(x.float()).all()) for x in first)


def test_prefill_step_on_card_matches_cpu(dev):
    """One bf16 prefill chunk of a tiny model (heads of 64) through the
    paged steps: the card (the tensor-core chunk kernel, one launch a
    layer) and the CPU (the plain version) give the same logits to 2^-5
    of the largest |logit| (bf16 matmuls and attention round in other
    places on the two)."""
    cfg = get_config("tiny", n_layer=2, d_model=256, n_head=4, n_kv_head=2,
                     d_ff=512, vocab_size=256, max_seq=256,
                     dtype="bfloat16")
    geom = kvc.make_geometry(cfg, n_slots=2, max_len=256, page_size=16,
                             mode="int8")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, 256, size=(2, 48)))
    tab = torch.arange(1, geom.n_pages, dtype=torch.int32).reshape(2, -1)
    start = torch.tensor([64, 0], dtype=torch.int32)
    clen = torch.tensor([48, 40], dtype=torch.int32)
    model = decoder.init(cfg, seed=0, device="cpu")
    got = {}
    for where in ("cpu", "cuda"):
        pools = kvc.init_pools(geom, where)
        pa.reset_launches()
        logits, _ = model.to(where).prefill_chunk_paged(
            tokens.to(where), pools, tab.to(where), start.to(where),
            clen.to(where))
        got[where] = logits.float().cpu()
        if where == "cuda":
            torch.cuda.synchronize()
            assert pa.LAUNCHES == {"decode": 0, "chunk": cfg.n_layer,
                                   "verify": 0}
    valid = torch.arange(48)[None, :] < clen[:, None]
    _normwise(got["cuda"][valid], got["cpu"][valid], 2.0 ** -5)


# ---------------------------------------------------------------------------
# the persistent one-head forward and the split chunk walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,hkv,d,window,prefix", [
    (8, 1024, 16, 16, 128, 0, None),     # llama-1.4b's attention
    (2, 1001, 16, 4, 128, 0, None),      # GQA, ragged S
    (2, 1000, 8, 2, 64, 257, None),      # D 64, a window
    (3, 400, 4, 2, 128, 0, (0, 150, 500))])
def test_flash_fwd_repeats_bit_for_bit(dev, b, s, h, hkv, d, window, prefix):
    """K1 (persistent, items from its own counter) gives the same out and
    lse bit for bit on every call, whichever block takes which item."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _flash_case(dev, torch.bfloat16, b, s, h, hkv, d, 9)
    pref = (None if prefix is None
            else torch.tensor(prefix, dtype=torch.int32, device=dev))
    kw = dict(causal=True, scale=d ** -0.5, window=window, prefix=pref)
    first = fa.flash_fwd_cuda(q, k, v, **kw)
    for _ in range(3):
        again = fa.flash_fwd_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
    assert bool(torch.isfinite(first[0].float()).all())


def test_flash_fwd_k1_and_k1p_alternate_on_one_stream(dev):
    """K1 and K1p are both persistent, each with its own item counter that
    its last block resets: launched alternately 20 times on one stream,
    each result equals its first bit for bit (a counter left dirty by
    either kernel would skip or repeat items of the next launch)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    one = _flash_case(dev, torch.bfloat16, 2, 1024, 16, 16, 128, 3)[:3]
    two = _flash_case(dev, torch.bfloat16, 2, 1024, 25, 25, 64, 4)[:3]
    kw = dict(causal=True, window=0)
    fa.reset_launches()
    first = (fa.flash_fwd_cuda(*one, scale=128 ** -0.5, **kw),
             fa.flash_fwd_cuda(*two, scale=64 ** -0.5, pack=2, **kw))
    for _ in range(20):
        a = fa.flash_fwd_cuda(*one, scale=128 ** -0.5, **kw)
        p = fa.flash_fwd_cuda(*two, scale=64 ** -0.5, pack=2, **kw)
        torch.cuda.synchronize()
        for got, want in ((a, first[0]), (p, first[1])):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert fa.LAUNCHES["flash_fwd"] == fa.LAUNCHES["flash_fwd_packed"] == 21


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("c", [200, 256, 512])
def test_chunk_at_every_planned_split(dev, mode, b, c):
    """The tensor-core chunk kernel at the split count the planner gives
    each shape (B 1, 2, 8 x C 200, 256, 512 at 2 KV heads of 4 query heads:
    1 to 8 splits), under chunk_bound, a repeated call equal bit for bit,
    and a planted fault (slot 0's middle held page dropped) caught."""
    starts = [1536 - 300 * (i % 4) for i in range(b)]
    held = [s_ + c for s_ in starts]
    q, pools, tab, pos, active = _chunk_tc_case(dev, mode, 128, starts, c,
                                                held, seed=b + c)
    kw = dict(scale=128 ** -0.5, window=0, kv_heads=2, variant="chunk")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-c * 4 // pa.SPLIT_ROWS["chunk"])
    splits = pa.plan_chunk_splits(b, 2, tiles, tab.shape[1], 16, sms)
    out = pa.paged_attention(q, pools, tab, pos, **kw)
    again = pa.paged_attention(q, pools, tab, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref, bound = chip_smoke.chunk_bound(q, _read_f32(pools, 2, 128), tab,
                                        pos, **kw)
    err, over, ratio = chip_smoke._held(out, ref, active, bound)
    assert over == 0, (splits, err, ratio)
    bad_tab = tab.clone()
    bad_tab[0, int((tab[0] >= 0).sum()) // 2] = -1
    bad = pa.paged_attention(q, pools, bad_tab, pos, **kw)
    assert chip_smoke._held(bad, ref, active, bound)[1] > 0, splits


def _ckpt_setup(dev, tmp_path, monkeypatch):
    """A small bf16 llama-shaped train state on ``dev``, its optimizer, one
    step and one batch, under a run id of its own."""
    import uuid

    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "cuda" + uuid.uuid4().hex[:12])
    cfg = get_config("tiny", n_layer=2, d_model=256, n_head=2, n_kv_head=1,
                     d_ff=512, vocab_size=512, max_seq=128)
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
    state = init_train_state(0, cfg, opt, device=dev)
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, 512, size=(2, 129)), device=dev)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    return cfg, opt, state, TrainStepBuilder(cfg, opt, device=dev).build(), \
        batch


def test_staged_pack_unchanged_by_the_next_step_on_card(dev, tmp_path,
                                                        monkeypatch):
    """The save's copies (device transposes, page-locked segment) end
    before ``save_to_memory`` returns: a step right after it, updating
    the state in place, leaves the pack as it was; a new engine restores
    it to the card bit for bit through the page-locked segment."""
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.models import convert
    from dlrover_tpu_torch.train.train_step import init_train_state

    cfg, opt, state, step, batch = _ckpt_setup(dev, tmp_path, monkeypatch)
    d = str(tmp_path / "ckpt")
    try:
        step(state, batch)  # moments and params away from their init
        eng = CheckpointEngine(d)
        assert eng.save_to_memory(1, convert.train_state_leaves(state, cfg,
                                                                opt))
        staged = convert.train_state_arrays(state, cfg, opt)
        step(state, batch)
        moved = convert.train_state_arrays(state, cfg, opt)
        assert any(not np.array_equal(moved[p], staged[p]) for p in staged)
        fresh = init_train_state(1, cfg, opt, device=dev)
        leaves = convert.train_state_leaves(fresh, cfg, opt)
        new = CheckpointEngine(d)
        assert new.load(leaves) == 1
        assert new.timings[-1]["tier"] == "memory"
        assert new.register_seconds > 0
        convert.load_scalars(fresh, leaves, opt)
        got = convert.train_state_arrays(fresh, cfg, opt)
        for p in staged:
            np.testing.assert_array_equal(got[p], staged[p], err_msg=p)
        new.close()
        eng.close()
    finally:
        CheckpointEngine.unlink_segment()
