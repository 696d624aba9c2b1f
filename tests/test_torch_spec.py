"""Speculative decoding in the port against the JAX package.

- ``Decoder.verify_chunk_paged`` against ``decoder.verify_chunk_paged``
  on the same weights (``models/convert.py``), pools, tables and
  tokens, llama- and gpt2-shaped, bf16 and int8 pools, in f32: logits
  rtol/atol 1e-4 and the returned chunk K/V rows 1e-5 (the tolerances
  of ``tests/test_torch_decoder.py``: same ops, other summation order).
- ``PromptLookupDraft`` proposes what the JAX one proposes.
- Greedy engine streams with ``spec_k=2`` equal the JAX engine's, at f32.
- Inside the port, token for token: spec-on == spec-off, greedy and
  sampled, bf16 and int8 pools (the draws are keyed on seed and
  absolute position, and the verify rows read as-committed values, so
  acceptance never moves the stream), and the mirrors of
  ``tests/test_serving_spec.py``: an oracle draft accepts everything, a
  wrong one nothing, rejected rows never reach the pools, a 1-token
  request never drafts, the counters reach the ``ServingRecord``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.serving import engine as jeng  # noqa: E402
from dlrover_tpu.serving import kv_cache as jkv  # noqa: E402
from dlrover_tpu.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.serving import kv_cache as tkv  # noqa: E402
from dlrover_tpu_torch.serving.engine import (  # noqa: E402
    DraftModel,
    PromptLookupDraft,
    ServingEngine,
    accept_and_emit,
)
from dlrover_tpu_torch.serving.scheduler import (  # noqa: E402
    SamplingParams,
    Scheduler,
)

_TINY = dict(n_layer=2, d_model=32, d_ff=64, n_head=4, vocab_size=32,
             max_seq=64, dtype="float32")
# repetitive prompts: prompt lookup finds trailing n-grams, so drafts are
# proposed and some are accepted (not just all-reject)
_PROMPTS = ([1, 2, 3, 1, 2, 3, 1], [5, 6, 5, 6, 5, 6, 5, 6, 5], [7, 8, 9, 7, 8])
_MAX_NEW = (8, 6, 7)
_ENGINE = dict(n_slots=2, max_len=32, page_size=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget("tiny", **_TINY), get_config("tiny", **_TINY)
    params = jdec.init(jax.random.key(0), jcfg)
    model = convert.load_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    return jcfg, cfg, params, model


def _serve(model, cfg, mode="bf16", spec_k=0, draft=None, sampling=None,
           prompts=_PROMPTS, max_new=_MAX_NEW, **kw):
    sched = Scheduler(replica="spec")
    eng = ServingEngine(model, cfg, sched, mode=mode, spec_k=spec_k,
                        draft=draft, device="cpu", **dict(_ENGINE, **kw))
    reqs = [sched.submit(p, m, sampling=s) for p, m, s in
            zip(prompts, max_new, sampling or [None] * len(prompts))]
    eng.drain(timeout=120)
    return eng, [r.future.result(timeout=5) for r in reqs]


# ------------------------------------------------------ verify_chunk_paged

_FAMILIES = {
    # llama-style: rmsnorm, swiglu, rope, untied head, GQA, a window
    "llama-gqa": dict(base="tiny", n_kv_head=2, tie_embeddings=False,
                      attn_window=10),
    # gpt2-style: learned positions, layernorm, gelu, tied head, muP
    "gpt2-learned": dict(base="tiny", pos="learned", norm="layernorm",
                         act="gelu", mup_base_width=16),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_verify_chunk_paged_matches_jax_f32(family, mode):
    kw = dict(_FAMILIES[family])
    base = kw.pop("base")
    kw.update(n_layer=3, d_model=32, d_ff=64, n_head=4, vocab_size=64,
              max_seq=64, dtype="float32")
    jcfg, cfg = jget(base, **kw), get_config(base, **kw)
    params = jdec.init(jax.random.key(1), jcfg)
    model = convert.load_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    geom = tkv.make_geometry(cfg, n_slots=3, max_len=32, page_size=4,
                             mode=mode)
    jgeom = jkv.PageGeometry(*geom)
    alloc = tkv.PageAllocator(geom, 3)
    lens = (26, 13, 30)
    for i, n in enumerate(lens):
        assert alloc.admit(i, n)
    tables = alloc.block_tables()
    # rows at every held position, so the chunk's own cells hold stale rows
    rng = np.random.default_rng(4)
    shape = (cfg.n_layer, 3, 32, cfg.kv_heads, cfg.head_dim)
    rows = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (3, 32))
    valid = pos < np.asarray(lens)[:, None]
    jpools = jkv.write_rows(jkv.init_pools(jgeom), jnp.asarray(tables),
                            jnp.asarray(pos), jnp.asarray(valid),
                            jnp.asarray(rows[0]), jnp.asarray(rows[1]),
                            jgeom)
    tpools = {n: torch.from_numpy(np.asarray(a).copy())
              for n, a in jpools.items()}
    before = {n: t.clone() for n, t in tpools.items()}
    toks = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    start = np.asarray([17, 6, 25], np.int32)
    jl, jck, jcv = jdec.verify_chunk_paged(
        params, jnp.asarray(toks), jpools, jnp.asarray(tables),
        jnp.asarray(start), jcfg, max_pages=8)
    tl, tck, tcv = model.verify_chunk_paged(
        torch.from_numpy(toks), tpools, torch.from_numpy(tables),
        torch.from_numpy(start), max_pages=8)
    assert tl.dtype == torch.float32 and tl.shape == (3, 4, cfg.vocab_size)
    assert tck.shape == (cfg.n_layer, 3, 4, cfg.kv_heads, cfg.head_dim)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tck), _np(jck), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tcv), _np(jcv), rtol=1e-5, atol=1e-5)
    for name, t in tpools.items():  # nothing was written
        assert torch.equal(t, before[name])


# --------------------------------------------------------------- drafting


def test_prompt_lookup_draft_matches_jax():
    mine, ref = PromptLookupDraft(), jeng.PromptLookupDraft()
    narrow = PromptLookupDraft(max_ngram=2, min_ngram=2)
    narrow_ref = jeng.PromptLookupDraft(max_ngram=2, min_ngram=2)
    rng = np.random.default_rng(0)
    for _ in range(300):
        hist = list(map(int, rng.integers(0, 5, size=rng.integers(0, 24))))
        k = int(rng.integers(0, 6))
        assert mine.propose(hist, k) == ref.propose(hist, k)
        assert narrow.propose(hist, k) == narrow_ref.propose(hist, k)


def test_prompt_lookup_draft_unit():
    d = PromptLookupDraft(max_ngram=3, min_ngram=1)
    assert d.propose([1, 2, 3, 9, 8, 1, 2, 3], 2) == [9, 8]
    # longest n-gram wins over shorter, more recent matches
    assert d.propose([5, 1, 2, 3, 7, 2, 3, 1, 2, 3], 1) == [7]
    assert d.propose([4, 6, 4, 5, 4], 1) == [5]
    assert d.propose([1, 2, 3, 4, 5], 3) == []
    assert d.propose([1, 2, 1, 2, 1], 8) == [2, 1]
    assert d.propose([1, 2, 3], 0) == [] and d.propose([], 4) == []
    with pytest.raises(ValueError):
        PromptLookupDraft(max_ngram=0)
    with pytest.raises(NotImplementedError):
        DraftModel().propose([1], 1)


def test_accept_and_emit_rule():
    """Row j's target is the argmax at row j (greedy); a draft survives
    iff it equals the previous row's target, up to the first miss."""
    b, c, v = 3, 4, 8
    want = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 1], [2, 2, 2, 2]])
    logits = torch.nn.functional.one_hot(want, v).float()
    tokens = torch.tensor([[0, 1, 2, 3],    # all three drafts right
                           [0, 5, 0, 7],    # second draft wrong
                           [0, 2, 2, 9]])   # only 1 draft offered
    n_draft = torch.tensor([3, 3, 1])
    valid = torch.tensor([True, True, False])
    zeros = torch.zeros(b)
    tgt, n_emit, commit = accept_and_emit(
        logits, tokens, torch.tensor([10, 3, 0]), valid, n_draft,
        zeros.long(), zeros, zeros.long(), torch.ones(b))
    assert torch.equal(tgt, want.int())
    assert n_emit.tolist() == [4, 2, 2]
    assert commit.tolist() == [[True] * 4, [True, True, False, False],
                               [False] * 4]


# --------------------------------------------------------- engine streams


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_greedy_spec_streams_equal_jax(setup, mode):
    jcfg, cfg, params, model = setup
    sched = JaxScheduler(replica="jax")
    eng = jeng.ServingEngine(params, jcfg, sched, mode=mode, spec_k=2,
                             **_ENGINE)
    reqs = [sched.submit(p, m) for p, m in zip(_PROMPTS, _MAX_NEW)]
    eng.drain(timeout=600)
    ref = [r.future.result(timeout=5) for r in reqs]
    mine, outs = _serve(model, cfg, mode, spec_k=2)
    assert outs == ref
    st, jst = mine.stats(), eng.stats()
    assert st["draft_tokens"] == jst["draft_tokens"] > 0
    assert st["accepted_tokens"] == jst["accepted_tokens"]


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_spec_on_equals_spec_off(setup, mode, sampled):
    _, cfg, _, model = setup
    sampling = ([SamplingParams(temperature=0.9, top_p=0.95, seed=i)
                 for i in range(len(_PROMPTS))] if sampled else None)
    _, off = _serve(model, cfg, mode, spec_k=0, sampling=sampling)
    eng, on = _serve(model, cfg, mode, spec_k=3, sampling=sampling)
    assert on == off
    st = eng.stats()
    assert st["spec_k"] == 3 and st["draft_tokens"] > 0
    assert 0 <= st["accepted_tokens"] <= st["draft_tokens"]
    assert st["tokens_generated"] == sum(_MAX_NEW)
    assert eng.active_slots() == 0
    assert eng.alloc.free_pages == eng.geom.n_pages - 1


class _OracleDraft(DraftModel):
    """Proposes the true continuation, looked up from reference streams."""

    def __init__(self, refs):
        self.refs = [list(r) for r in refs]

    def propose(self, history, k):
        hist = [int(t) for t in history]
        for ref in self.refs:
            if ref[:len(hist)] == hist:
                return ref[len(hist):len(hist) + k]
        return []


class _WrongDraft(DraftModel):
    """Proposes a constant token that no reference stream contains."""

    def __init__(self, token):
        self.token = int(token)

    def propose(self, history, k):
        return [self.token] * k


def _unused_token(refs, vocab):
    used = {t for r in refs for t in r}
    return next(t for t in range(vocab - 1, 0, -1) if t not in used)


def test_oracle_draft_accepts_everything(setup):
    _, cfg, _, model = setup
    _, refs = _serve(model, cfg)
    eng, outs = _serve(model, cfg, spec_k=3, draft=_OracleDraft(refs))
    assert outs == refs
    st = eng.stats()
    assert st["draft_tokens"] > 0
    assert st["accepted_tokens"] == st["draft_tokens"]
    assert st["spec_accept_rate"] == 1.0


def test_wrong_draft_rejects_everything_same_output(setup):
    _, cfg, _, model = setup
    _, refs = _serve(model, cfg)
    bad = _unused_token(refs, cfg.vocab_size)
    eng, outs = _serve(model, cfg, spec_k=3, draft=_WrongDraft(bad))
    assert outs == refs  # >= 1 token of progress per step
    st = eng.stats()
    assert st["draft_tokens"] > 0 and st["accepted_tokens"] == 0
    assert st["spec_accept_rate"] == 0.0


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_rejected_draft_rows_never_reach_pools(setup, mode):
    """Across each verify step with every draft rejected, every pool cell
    of the slot past the one committed row is byte-identical, and the
    slot's reservation never grows."""
    _, cfg, _, model = setup
    prompt, m = _PROMPTS[0], _MAX_NEW[0]
    _, (ref,) = _serve(model, cfg, mode, prompts=[prompt], max_new=[m])
    sched = Scheduler(replica="spec-inv")
    eng = ServingEngine(model, cfg, sched, mode=mode, spec_k=3,
                        draft=_WrongDraft(_unused_token([ref], 32)),
                        device="cpu", **dict(_ENGINE, n_slots=1))
    r = sched.submit(prompt, m)
    while eng.slots[0] is None or eng.slots[0].phase != "decode":
        assert eng.step()
    ps, total = eng.geom.page_size, len(prompt) + m
    pages0 = eng.alloc.slot_pages(0)

    def cell(pos):
        page = eng.alloc.block_tables()[0][pos // ps]
        return {n: a[:, page, pos % ps].clone() for n, a in eng.pools.items()}

    while eng.slots[0] is not None:
        n_before = len(eng.slots[0].generated)
        if n_before >= m:
            eng.step()  # the final eviction only
            break
        frontier = len(prompt) + n_before  # first row not yet written
        pre = [cell(p) for p in range(frontier, total)]
        assert eng.step()
        s = eng.slots[0]
        assert (len(s.generated) if s is not None else m) == n_before + 1
        assert eng.alloc.slot_pages(0) == pages0
        post = [cell(p) for p in range(frontier, total)]
        for a, b in zip(pre[1:], post[1:]):
            for name in a:
                assert torch.equal(a[name], b[name]), name
    assert r.future.result(timeout=5) == ref


def test_spec_with_max_new_one_falls_back_to_decode(setup):
    """k_eff = min(spec_k, remaining - 1): a 1-token request never
    drafts and still matches spec-off."""
    _, cfg, _, model = setup
    _, ref = _serve(model, cfg, prompts=_PROMPTS[:1], max_new=[1])
    eng, outs = _serve(model, cfg, spec_k=3, prompts=_PROMPTS[:1],
                       max_new=[1])
    assert outs == ref
    assert eng.stats()["draft_tokens"] == 0


def test_spec_counters_flow_to_serving_record_and_trace(setup):
    from dlrover_tpu_torch.observability import tracing

    _, cfg, _, model = setup
    tr = tracing.configure_tracer("test-spec", force=True)
    try:
        eng, _ = _serve(model, cfg, spec_k=3)
        events = tr.events()
    finally:
        tracing.reset_tracer()
    st = eng.stats()
    rec = Scheduler(replica="spec-rec").publish(st)
    assert rec.draft_tokens == st["draft_tokens"] > 0
    assert rec.accepted_tokens == st["accepted_tokens"]
    assert rec.spec_accept_rate == pytest.approx(st["spec_accept_rate"])
    spans = [e for e in events if e["name"] == "serving.spec_verify"]
    assert spans and all(e["args"]["drafts"] > 0 for e in spans)
    # one span per verify step; each emits one token per live lane plus
    # the lane's accepted drafts
    assert st["verify_steps"] == len(spans)
    assert st["verify_tokens"] == sum(e["args"]["emitted"] for e in spans)
    assert st["verify_tokens"] >= st["verify_steps"] + st["accepted_tokens"]


def test_negative_spec_k_raises(setup):
    _, cfg, _, model = setup
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(model, cfg, Scheduler(), spec_k=-1, device="cpu")
