"""Prefix sharing in the port against the JAX package.

- ``serving/prefix.py`` (the port's own copy): ``PrefixIndex``,
  ``plan_admission`` and ``affinity_ok`` give what the JAX module gives
  on the same random traces, plus the unit cases of
  ``tests/test_serving_prefix.py``.
- ``PageAllocator`` refcounts: a random admit / admit_shared / cow_page
  / ensure / evict trace gives the JAX allocator's tables, refcounts,
  free lists and ``on_free`` lists, step for step.
- Greedy engine streams with sharing on equal the JAX engine's, at f32.
- Inside the port, token for token: a request admitted on a prefix hit
  emits the stream it emits cold (bf16 and int8 pools, spec on and
  off); evicting the sharer never moves the sharee's pages; a
  copy-on-write tail page isolates the writes; hit-aware lookahead
  admits a hot request past a blocked cold head, which still runs.
"""

from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.serving import kv_cache as jkv  # noqa: E402
from dlrover_tpu.serving import prefix as jpre  # noqa: E402
from dlrover_tpu.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from dlrover_tpu.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.serving import kv_cache as tkv  # noqa: E402
from dlrover_tpu_torch.serving import prefix as tpre  # noqa: E402
from dlrover_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from dlrover_tpu_torch.serving.scheduler import Scheduler  # noqa: E402

_TINY = dict(n_layer=2, d_model=32, d_ff=64, n_head=4, vocab_size=32,
             max_seq=64, dtype="float32")


# ------------------------------------------------------------ index units


def test_trie_intern_lookup_partial_tail():
    trie = tpre.PrefixIndex(4)
    toks = list(range(1, 13))
    assert trie.intern(toks, 3, np.array([5, 6, 7])) == 3
    m = trie.lookup(toks)
    assert m.pages == (5, 6, 7) and m.tail_tokens == 0
    assert m.matched_tokens(4) == 12
    m2 = trie.lookup(toks[:6] + [99, 99, 98])
    assert m2.pages == (5,) and m2.tail_page == 6 and m2.tail_tokens == 2
    miss = trie.lookup([31, 30, 29, 28])
    assert miss.pages == () and miss.tail_page is None
    m3 = trie.lookup(toks[:3])
    assert m3.pages == () and m3.tail_page == 5 and m3.tail_tokens == 3


def test_trie_keep_first_and_subtree_drop():
    trie = tpre.PrefixIndex(2)
    trie.intern([1, 2, 3, 4], 2, np.array([5, 6]))
    assert trie.intern([1, 2, 3, 4], 2, np.array([9, 10])) == 0
    assert trie.lookup([1, 2, 3, 4]).pages == (5, 6)
    assert trie.intern([1, 2, 7, 7], 2, np.array([9, 10])) == 1
    assert trie.lookup([1, 2, 7, 7]).pages == (5, 10)
    assert trie.drop_pages([6]) == 1
    assert trie.lookup([1, 2, 3, 4]).pages == (5,)
    assert trie.drop_pages([5]) == 2 and trie.n_pages == 0
    assert trie.drop_pages([5, 42]) == 0
    assert trie.stats() == {"pages": 0, "interned_total": 3,
                            "dropped_total": 3}


def test_plan_admission_units():
    P = tpre.PrefixMatch
    plan = tpre.plan_admission(P((5, 6, 7), None, 0), 16, 4, 4)
    assert plan == tpre.AdmissionPlan((5, 6, 7), (), 12, 12)
    plan = tpre.plan_admission(P((5,), 6, 2), 8, 4, 2)
    assert plan.shared == (5,) and plan.cow == ((1, 6),)
    assert plan.resume == 6 and plan.prefix_pages == (5, 6)
    # a whole-prompt match re-runs the last token: resume 8 → 7 → 4
    assert tpre.plan_admission(P((5, 6), None, 0), 8, 4, 4).resume == 4
    plan2 = tpre.plan_admission(P((5, 6), None, 0), 8, 4, 2)
    assert plan2.resume == 6 and plan2.cow == ((1, 6),)
    assert tpre.plan_admission(P((5, 6), None, 0), 8, 4, 8) is None
    assert tpre.plan_admission(P((), None, 0), 8, 4, 4) is None
    assert tpre.plan_admission(P((), 6, 2), 8, 4, 4) is None
    assert tpre.affinity_ok(plan, 9, 3) and not tpre.affinity_ok(plan, 9, 2)
    assert not tpre.affinity_ok(None, 9, 3)


def test_index_and_planner_match_jax_on_a_random_trace():
    """Same intern / lookup / drop trace through both modules: every
    return value, match, plan and statistic agrees."""
    rng = np.random.default_rng(0)
    mine, ref = tpre.PrefixIndex(3), jpre.PrefixIndex(3)
    next_page = 1
    for _ in range(400):
        toks = list(map(int, rng.integers(0, 3, size=rng.integers(1, 16))))
        op = rng.random()
        if op < 0.4:
            n = len(toks) // 3
            row = np.arange(next_page, next_page + n)
            next_page += n
            assert mine.intern(toks, n, row) == ref.intern(toks, n, row)
        elif op < 0.55:
            pages = list(map(int, rng.integers(1, next_page + 1, size=3)))
            assert mine.drop_pages(pages) == ref.drop_pages(pages)
        m, r = mine.lookup(toks), ref.lookup(toks)
        assert tuple(m) == tuple(r)
        for chunk in (1, 2, 3, 4):
            pm = tpre.plan_admission(m, len(toks), 3, chunk)
            pr = jpre.plan_admission(r, len(toks), 3, chunk)
            assert (pm is None) == (pr is None)
            if pm is not None:
                assert tuple(pm) == tuple(pr)
                assert pm.prefix_pages == pr.prefix_pages
            for cap in (0, 2, 5):
                assert tpre.affinity_ok(pm, len(toks), cap) == \
                    jpre.affinity_ok(pr, len(toks), cap)
        assert mine.stats() == ref.stats() and len(mine) == len(ref)


# -------------------------------------------------------------- allocator


def _check_alloc(alloc, geom):
    """Refcount conservation and the free/assigned partition."""
    cells = Counter(int(p) for row in alloc._tables for p in row if p >= 0)
    for page in range(geom.n_pages):
        assert alloc.refcount(page) == cells.get(page, 0), page
    free = set(alloc._free)
    assert len(alloc._free) == len(free)
    assert set(cells) | free == set(range(1, geom.n_pages))
    assert not free & set(cells)
    assert alloc.unique_assigned_pages == len(cells)


def test_allocator_refcount_cow_trace_matches_jax():
    cfg = get_config("tiny", **_TINY)
    geom = tkv.make_geometry(cfg, n_slots=4, max_len=24, page_size=4,
                             mode="int8")
    mine = tkv.PageAllocator(geom, 4)
    ref = jkv.PageAllocator(jkv.PageGeometry(*geom), 4)
    freed = {"mine": [], "ref": []}
    mine.on_free = freed["mine"].append
    ref.on_free = freed["ref"].append
    rng = np.random.default_rng(7)
    for _ in range(400):
        slot = int(rng.integers(4))
        n = int(rng.integers(0, geom.max_len + 6))
        op = rng.random()
        if op < 0.3 and mine.slot_pages(slot) == 0:
            # map a prefix of another live slot's pages
            donors = [i for i in range(4) if mine.slot_pages(i)]
            shared = []
            if donors:
                d = donors[int(rng.integers(len(donors)))]
                k = int(rng.integers(0, mine.slot_pages(d) + 1))
                shared = [int(p) for p in mine.block_tables()[d, :k]]
            assert mine.can_admit(n, len(shared)) == ref.can_admit(
                n, len(shared))
            if len(shared) <= mine.pages_needed(n):
                assert mine.admit_shared(slot, n, shared) == \
                    ref.admit_shared(slot, n, shared)
        elif op < 0.45 and mine.slot_pages(slot):
            logical = int(rng.integers(mine.slot_pages(slot)))
            if mine.free_pages:
                assert mine.cow_page(slot, logical) == \
                    ref.cow_page(slot, logical)
        elif op < 0.6 and mine.slot_pages(slot) == 0:
            assert mine.admit(slot, n) == ref.admit(slot, n)
        elif op < 0.75:
            assert mine.ensure(slot, n) == ref.ensure(slot, n)
        else:
            assert mine.evict(slot) == ref.evict(slot)
        np.testing.assert_array_equal(mine.block_tables(), ref.block_tables())
        assert [mine.refcount(p) for p in range(geom.n_pages)] == \
            [ref.refcount(p) for p in range(geom.n_pages)]
        assert mine.free_pages == ref.free_pages
        assert mine.unique_assigned_pages == ref.unique_assigned_pages
        assert mine.consume_dirty() == ref.consume_dirty()
        assert freed["mine"] == freed["ref"]
        _check_alloc(mine, geom)
    assert freed["mine"] and max(mine._rc) >= 1


def test_allocator_rejects_bad_shared_admissions():
    cfg = get_config("tiny", **_TINY)
    geom = tkv.make_geometry(cfg, n_slots=2, max_len=16, page_size=4,
                             mode="bf16")
    alloc = tkv.PageAllocator(geom, 2)
    assert alloc.admit(0, 8)
    with pytest.raises(ValueError, match="already holds"):
        alloc.admit_shared(0, 8, [])
    with pytest.raises(ValueError, match="not live"):
        alloc.admit_shared(1, 8, [7])
    with pytest.raises(ValueError, match="exceeds"):
        alloc.admit_shared(1, 4, [1, 2])
    with pytest.raises(ValueError, match="no logical page"):
        alloc.cow_page(0, 5)
    assert alloc.cow_page(0, 0) is None  # private: nothing to copy


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget("tiny", **_TINY), get_config("tiny", **_TINY)
    params = jdec.init(jax.random.key(0), jcfg)
    model = convert.load_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    rng = np.random.default_rng(1)
    prefix = list(map(int, rng.integers(1, 32, size=12)))
    return jcfg, cfg, params, model, prefix + [3, 4], prefix + [9, 8, 7]


def _engine(model, cfg, *, sharing=True, lookahead=0, **kw):
    sched = Scheduler(replica="px")
    base = dict(n_slots=2, max_len=32, page_size=4, mode="bf16",
                prefill_chunk=4, prefix_sharing=sharing,
                admission_lookahead=lookahead, device="cpu")
    base.update(kw)
    return sched, ServingEngine(model, cfg, sched, **base)


def _commit_donor(eng, sched, donor_p, max_new=16):
    """Admit the donor alone and step until its prompt is committed."""
    rd = sched.submit(donor_p, max_new)
    for _ in range(40):
        eng.step()
        s = next((s for s in eng.slots if s is not None), None)
        if s is not None and s.phase == "decode":
            return rd
    raise AssertionError("donor never reached decode")


def _cold(model, cfg, prompt, max_new, **kw):
    sched, eng = _engine(model, cfg, sharing=False, **kw)
    r = sched.submit(prompt, max_new)
    eng.drain(timeout=120)
    return r.future.result(timeout=5)


def _donor_then_follower(model, cfg, donor_p, foll_p, **kw):
    sched, eng = _engine(model, cfg, **kw)
    rd = _commit_donor(eng, sched, donor_p)
    chunks = eng.stats()["prefill_chunks"]
    rf = sched.submit(foll_p, 5)
    eng.drain(timeout=120)
    return eng, (rd.future.result(5), rf.future.result(5)), chunks


@pytest.mark.parametrize("mode,spec_k", [("bf16", 0), ("int8", 2)])
def test_greedy_sharing_streams_equal_jax(setup, mode, spec_k):
    jcfg, cfg, params, model, donor_p, foll_p = setup
    sched = JaxScheduler(replica="jax")
    jeng = JaxEngine(params, jcfg, sched, n_slots=2, max_len=32,
                     page_size=4, mode=mode, prefill_chunk=4,
                     spec_k=spec_k, prefix_sharing=True)
    rd = sched.submit(donor_p, 16)
    for _ in range(40):
        jeng.step()
        if any(s is not None and s.phase == "decode" for s in jeng.slots):
            break
    rf = sched.submit(foll_p, 5)
    jeng.drain(timeout=600)
    ref = (rd.future.result(5), rf.future.result(5))
    eng, outs, _ = _donor_then_follower(model, cfg, donor_p, foll_p,
                                        mode=mode, spec_k=spec_k)
    assert outs == ref
    st, jst = eng.stats(), jeng.stats()
    for key in ("prefix_hits", "prefix_misses", "prefill_tokens_saved",
                "cow_pages", "prefill_chunks"):
        assert st[key] == jst[key], key


@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_prefix_hit_stream_equals_cold(setup, mode, spec_k):
    """The follower admitted on a hit (12 of its 15 prompt tokens mapped
    from the donor's pages) emits its cold stream, in one prefill chunk
    where cold takes four."""
    _, cfg, _, model, donor_p, foll_p = setup
    eng, (out_d, out_f), chunks = _donor_then_follower(
        model, cfg, donor_p, foll_p, mode=mode, spec_k=spec_k)
    assert out_d == _cold(model, cfg, donor_p, 16, mode=mode)
    assert out_f == _cold(model, cfg, foll_p, 5, mode=mode)
    st = eng.stats()
    assert st["prefix_hits"] == 1 and st["prefill_tokens_saved"] == 12
    assert st["prefill_chunks"] - chunks == 1
    assert st["prefix_hit_rate"] == 0.5  # the donor was the one miss
    assert st["peak_dedup_ratio"] > 1.0
    assert eng.alloc.free_pages == eng.geom.n_pages - 1
    assert st["trie_pages"] == 0 and st["dedup_ratio"] == 1.0
    _check_alloc(eng.alloc, eng.geom)
    rec = Scheduler(replica="px-rec").publish(st)
    assert rec.prefix_hit_rate == 0.5 and rec.prefill_tokens_saved == 12


def test_sharer_eviction_never_perturbs_sharee(setup):
    _, cfg, _, model, donor_p, foll_p = setup
    sched, eng = _engine(model, cfg)
    rd = _commit_donor(eng, sched, donor_p, max_new=4)
    rf = sched.submit(foll_p, 5)
    while not any(s is not None and s.req is rf for s in eng.slots):
        eng.step()
    slot_f = next(i for i, s in enumerate(eng.slots)
                  if s is not None and s.req is rf)
    shared = [int(p) for p in eng.alloc.block_tables()[slot_f, :3]]
    assert all(eng.alloc.refcount(p) == 2 for p in shared)
    assert eng.dedup_ratio() > 1.0
    before = {k: v[:, shared].clone() for k, v in eng.pools.items()}
    while any(s is not None and s.req is rd for s in eng.slots) \
            or not rd.future.done():
        eng.step()
    assert rd.future.result(5) == _cold(model, cfg, donor_p, 4)
    assert all(eng.alloc.refcount(p) == 1 for p in shared)
    for k, v in eng.pools.items():
        assert torch.equal(before[k], v[:, shared])
    eng.drain(timeout=120)
    assert rf.future.result(5) == _cold(model, cfg, foll_p, 5)
    assert eng.alloc.free_pages == eng.geom.n_pages - 1


def test_cow_tail_page_isolates_writes(setup):
    """A follower with the donor's whole prompt (chunk 2: resume 14 lands
    inside page 3) copies that page before re-running its last chunk;
    the donor's pages do not move a byte."""
    _, cfg, _, model, donor_p, _ = setup
    prompt = donor_p + [1, 2]  # 16 tokens = 4 committed pages
    sched, eng = _engine(model, cfg, prefill_chunk=2)
    rd = _commit_donor(eng, sched, prompt, max_new=12)
    donor_slot = next(i for i, s in enumerate(eng.slots) if s is not None)
    donor_phys = [int(p) for p in eng.alloc.block_tables()[donor_slot, :4]]
    donor_bytes = {k: v[:, donor_phys].clone() for k, v in eng.pools.items()}
    rf = sched.submit(prompt, 5)
    eng.drain(timeout=120)
    st = eng.stats()
    assert rf.future.result(5) == _cold(model, cfg, prompt, 5,
                                        prefill_chunk=2)
    assert rd.future.result(5) == _cold(model, cfg, prompt, 12,
                                        prefill_chunk=2)
    assert st["cow_pages"] == 1 and st["prefix_hits"] == 1
    assert st["prefill_tokens_saved"] == 14
    for k, v in eng.pools.items():
        assert torch.equal(donor_bytes[k], v[:, donor_phys])


def _squeeze(alloc, n):
    """Take ``n`` pages off the free list (a stand-in for pages another
    tenant holds); returns them for ``_release``."""
    return [alloc._free.pop() for _ in range(n)]


def _release(alloc, pages):
    alloc._free.extend(reversed(pages))


def test_hit_aware_lookahead_admits_past_blocked_cold_head(setup):
    _, cfg, _, model, donor_p, foll_p = setup
    sched, eng = _engine(model, cfg, lookahead=2)
    rd = _commit_donor(eng, sched, donor_p)  # holds 8 of 16 pages
    # 3 pages left: a cold 20-token request (5 pages) blocks while the
    # hot one (5 pages, 3 of them shared) fits
    held = _squeeze(eng.alloc, 5)
    cold = sched.submit(list(np.arange(1, 18) % 31 + 1), 3)
    hot = sched.submit(foll_p, 5)
    for _ in range(12):
        eng.step()
    assert hot.future.done()
    assert hot.future.result(5) == _cold(model, cfg, foll_p, 5)
    assert not cold.future.done() and sched.queue_depth() == 1
    assert not rd.future.done()
    _release(eng.alloc, held)
    eng.drain(timeout=120)
    assert len(cold.future.result(5)) == 20
    assert eng.stats()["prefix_hits"] == 1
    assert eng.alloc.free_pages == eng.geom.n_pages - 1


def test_lookahead_zero_preserves_head_of_line(setup):
    _, cfg, _, model, donor_p, foll_p = setup
    sched, eng = _engine(model, cfg, lookahead=0)
    _commit_donor(eng, sched, donor_p)
    held = _squeeze(eng.alloc, 5)
    cold = sched.submit(list(np.arange(1, 18) % 31 + 1), 3)
    hot = sched.submit(foll_p, 5)
    for _ in range(8):
        eng.step()
    assert not hot.future.done() and not cold.future.done()
    assert sched.queue_depth() == 2
    _release(eng.alloc, held)
    eng.drain(timeout=120)
    assert hot.future.result(5) == _cold(model, cfg, foll_p, 5)


def test_sharing_off_engine_reports_inert_prefix_stats(setup):
    _, cfg, _, model, donor_p, foll_p = setup
    sched, eng = _engine(model, cfg, sharing=False)
    _commit_donor(eng, sched, donor_p)
    rf = sched.submit(foll_p, 5)
    eng.drain(timeout=120)
    rf.future.result(5)
    st = eng.stats()
    assert st["prefix_hits"] == 0 and st["prefix_misses"] == 0
    assert st["prefix_hit_rate"] == 0.0 and st["trie_pages"] == 0
    assert st["cow_pages"] == 0 and st["peak_dedup_ratio"] == 1.0
