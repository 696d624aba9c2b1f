"""Live KV-page migration in the port against the JAX package.

The allocator's reservations replay the JAX allocator's trace; the
``DTKV1`` wire gives the same bytes in both packages, and each decodes
the other's blobs (bf16 pages ship as raw 16-bit words in the port,
which has no numpy bfloat16); a page blob exported by one package's
engine resumes on the other's and continues the never-migrated greedy
stream. Then the port's kill drills (the JAX drills, on the port): a
killed replica's slots migrate live with zero re-prefilled tokens, a
faulted migration degrades to re-prefill with the same streams, and
``wait_all`` backs off. Tiny config in f32; the victim is parked and
stepped by hand to a known state before the kill, never on a timer.
"""

import concurrent.futures
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.serving import kv_cache as jkv  # noqa: E402
from dlrover_tpu.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from dlrover_tpu.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from dlrover_tpu_torch.elastic import faults  # noqa: E402
from dlrover_tpu_torch.elastic.resharding import PhaseBudgets  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.observability import telemetry  # noqa: E402
from dlrover_tpu_torch.serving import kv_cache as tkv  # noqa: E402
from dlrover_tpu_torch.serving import migration as mig  # noqa: E402
from dlrover_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from dlrover_tpu_torch.serving.replica import (  # noqa: E402
    ReplicaRouter, ServingReplica,
)
from dlrover_tpu_torch.serving.scheduler import (  # noqa: E402
    SamplingParams, Scheduler,
)
from dlrover_tpu_torch.serving.server import GenerationServer  # noqa: E402

_KW = dict(n_layer=2, d_model=32, d_ff=64, n_head=4, n_kv_head=2,
           vocab_size=64, max_seq=64, dtype="float32")
_ENGINE = dict(n_slots=4, max_len=32, page_size=4, prefill_chunk=4)
_SERVER = dict(_ENGINE, idle_sleep=0.001, device="cpu")


@pytest.fixture(scope="module")
def jmig():
    """The JAX package's migration wire, imported where it is used: the
    JAX side of this file is the wire and one engine's export, no JAX
    replica or drill."""
    from dlrover_tpu.serving import migration

    return migration


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget("tiny", **_KW), get_config("tiny", **_KW)
    params = jdec.init(jax.random.key(0), jcfg)
    model = convert.load_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    return jcfg, cfg, params, model


# ------------------------------------------------------------ allocator


def test_reservation_trace_matches_jax():
    """admit / ensure / evict / reserve / commit / abort over a geometry
    with slack pages: the same tables, free counts, reservations and
    return values as the JAX allocator."""
    cfg = get_config("tiny", **_KW)
    geom = tkv.make_geometry(cfg, n_slots=4, max_len=24, page_size=4,
                             mode="int8", slack_pages=5)
    jgeom = jkv.make_geometry(jget("tiny", **_KW), n_slots=4, max_len=24,
                              page_size=4, mode="int8", slack_pages=5)
    assert tuple(geom) == tuple(jgeom)
    mine, ref = tkv.PageAllocator(geom, 4), jkv.PageAllocator(jgeom, 4)
    rng = np.random.default_rng(5)
    tags = [f"t{i}" for i in range(4)]
    held = set()  # tags with a reservation (possibly of zero pages)
    for _ in range(400):
        slot = int(rng.integers(4))
        tag = tags[int(rng.integers(4))]
        n = int(rng.integers(0, geom.max_len + 6))
        op = rng.random()
        if op < 0.2:
            if mine.slot_pages(slot) == 0:
                assert mine.admit(slot, n) == ref.admit(slot, n)
        elif op < 0.35:
            assert mine.ensure(slot, n) == ref.ensure(slot, n)
        elif op < 0.5:
            assert mine.evict(slot) == ref.evict(slot)
        elif op < 0.7:
            if tag not in held:
                ok = mine.reserve_for_migration(tag, n)
                assert ok == ref.reserve_for_migration(tag, n)
                if ok:
                    held.add(tag)
            else:
                with pytest.raises(ValueError):
                    mine.reserve_for_migration(tag, n)
        elif op < 0.85:
            if tag in held and mine.slot_pages(slot) == 0:
                assert (mine.commit_migration(tag, slot)
                        == ref.commit_migration(tag, slot))
                held.discard(tag)
            elif tag not in held:
                with pytest.raises(KeyError):
                    mine.commit_migration(tag, slot)
        else:
            assert mine.abort_migration(tag) == ref.abort_migration(tag)
            held.discard(tag)
        np.testing.assert_array_equal(mine.block_tables(), ref.block_tables())
        assert mine.free_pages == ref.free_pages
        assert mine.reserved_pages == ref.reserved_pages
        assert all(mine.reservation(t) == ref.reservation(t) for t in tags)
        assert mine.consume_dirty() == ref.consume_dirty()
    # free + assigned + reserved partition the pages but the trash page
    assigned = {int(p) for p in mine.block_tables().ravel() if p >= 0}
    reserved = {p for t in tags for p in mine.reservation(t)}
    assert (len(assigned) + len(reserved) + mine.free_pages
            == geom.n_pages - 1)


# ------------------------------------------------------------------ wire


def _pages(mode):
    """The same random pages as numpy (JAX's export) and torch (the
    port's): int8 payloads and f32 scales, or bf16 rows."""
    rng = np.random.default_rng(7)
    if mode == "int8":
        pages = {
            "k_q": rng.integers(-127, 128, (2, 3, 4, 4, 8)).astype(np.int8),
            "k_scale": rng.random((2, 3, 4, 4)).astype(np.float32),
            "v_q": rng.integers(-127, 128, (2, 3, 4, 4, 8)).astype(np.int8),
            "v_scale": rng.random((2, 3, 4, 4)).astype(np.float32),
        }
        return pages, {k: torch.from_numpy(v.copy()) for k, v in pages.items()}
    arr = rng.standard_normal((2, 2, 3, 4, 4, 8)).astype(np.float32)
    theirs = {k: np.asarray(jnp.asarray(a, jnp.bfloat16))
              for k, a in zip(("k", "v"), arr)}
    mine = {k: torch.from_numpy(a).to(torch.bfloat16)
            for k, a in zip(("k", "v"), arr)}
    return theirs, mine


_META = dict(rid="rep-1/r3", prompt=[5, 6, 7], generated=[8, 9],
             n_prefilled=3, phase="decode", max_new_tokens=6, seed=11,
             page_size=4, n_layers=2, kv_heads=4, head_dim=8, kv_block=8)


def _snaps(jmig, mode, page_start=0):
    theirs, mine = _pages(mode)
    meta = dict(_META, mode=mode, page_start=page_start)
    return (jmig.RequestSnapshot(pages=theirs, **meta),
            mig.RequestSnapshot(pages=mine, **meta))


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("page_start", [0, 2])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_the_blob_is_the_jax_blob_and_each_decodes_the_other(jmig, mode,
                                                             page_start):
    jsnap, snap = _snaps(jmig, mode, page_start)
    blob = mig.encode_snapshot(snap)
    assert blob == jmig.encode_snapshot(jsnap)
    mine, theirs = mig.decode_snapshot(blob), jmig.decode_snapshot(blob)
    for out in (mine, theirs):
        assert (out.rid, out.prompt, out.generated, out.page_start,
                out.phase, out.seed, out.mode) == (
            snap.rid, snap.prompt, snap.generated, page_start, "decode",
            11, mode)
        assert out.n_pages == 3 and out.tokens_resident == 5
        assert set(out.pages) == set(snap.pages)
    for k in snap.pages:
        assert mine.pages[k].dtype == snap.pages[k].dtype
        assert theirs.pages[k].dtype.name == jsnap.pages[k].dtype.name
        np.testing.assert_array_equal(_as_f32(mine.pages[k]),
                                      _as_f32(snap.pages[k]))
        np.testing.assert_array_equal(_as_f32(theirs.pages[k]),
                                      _as_f32(snap.pages[k]))
    # and a fragment (no pages) encodes alike
    empty = dict(_META, mode=mode, page_start=page_start)
    assert mig.encode_snapshot(mig.RequestSnapshot(**empty)) == \
        jmig.encode_snapshot(jmig.RequestSnapshot(**empty))


def _torn(blob):
    flipped = bytearray(blob)
    flipped[-3] ^= 0x40
    return {
        "truncated_payload": blob[:-7],
        "truncated_header": blob[: len(b"DTKV1\n") + 10],
        "bad_magic": b"XX" + blob,
        "garbage": b"\x00" * 64,
        "bit_flip": bytes(flipped),
    }


@pytest.mark.parametrize("case", ["truncated_payload", "truncated_header",
                                  "bad_magic", "garbage", "bit_flip"])
def test_a_torn_blob_raises_in_both_packages(jmig, case):
    jsnap, snap = _snaps(jmig, "int8")
    bad = _torn(mig.encode_snapshot(snap))[case]
    with pytest.raises(mig.TornPageTransfer):
        mig.decode_snapshot(bad)
    with pytest.raises(jmig.TornPageTransfer):
        jmig.decode_snapshot(bad)
    assert issubclass(mig.TornPageTransfer, faults.TornDonation)
    if case == "bit_flip":
        with pytest.raises(mig.TornPageTransfer, match="checksum"):
            mig.decode_snapshot(bad)


# ------------------------------------------------- engines across packages


def _jax_engine(setup, mode):
    jcfg, _, params, _ = setup
    sched = JaxScheduler(replica="jax")
    return sched, JaxEngine(params, jcfg, sched, mode=mode, **_ENGINE)


def _port_engine(setup, mode):
    _, cfg, _, model = setup
    sched = Scheduler(replica="port")
    return sched, ServingEngine(model, cfg, sched, mode=mode, device="cpu",
                                **_ENGINE)


def _prefill(eng, decode_steps=0):
    """Admit the queued request into slot 0 and prefill it, then run
    ``decode_steps`` decode steps: a known state, stepped by hand."""
    eng._admit()
    while eng.slots[0].phase == "prefill":
        eng._prefill_one()
    for _ in range(decode_steps):
        eng._decode_batch()


_PROMPT = [7, 3, 9, 12, 5, 30, 2, 8, 41, 6, 17]


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_export_pages_after_the_same_prefill_matches_jax(setup, mode):
    jsched, jeng = _jax_engine(setup, mode)
    psched, peng = _port_engine(setup, mode)
    jsched.submit(_PROMPT, 6)
    psched.submit(_PROMPT, 6)
    _prefill(jeng)
    _prefill(peng)
    assert peng.slots[0].generated == jeng.slots[0].generated
    theirs, mine = jeng.export_pages(0), peng.export_pages(0)
    assert set(mine) == set(theirs)
    for k in mine:
        got, want = mine[k].numpy(), np.asarray(theirs[k])
        assert got.shape == want.shape and got.dtype == want.dtype
        if k in ("k_q", "v_q"):
            assert np.abs(got.astype(np.int32)
                          - want.astype(np.int32)).max() <= 1
        else:  # relative to the largest magnitude of the pool
            rtol = 1e-6 if k.endswith("_scale") else 1e-5
            assert np.abs(got - want).max() <= rtol * np.abs(want).max()
    # a range of logical pages is that slice of the whole
    part = peng.export_pages(0, 1, 2)
    for k in mine:
        torch.testing.assert_close(part[k], mine[k][:, 1:2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="outside"):
        peng.export_pages(0, 2, 9)


def _resume(sched, eng, blob, decode, max_new):
    """Import a blob into ``eng`` over a reservation, as the migrator's
    resume phase does, and drain; returns the stream."""
    req = sched.submit(_PROMPT, max_new)
    assert sched.pop_next() is req
    assert eng.alloc.reserve_for_migration(req.rid, req.total_tokens)
    snap = decode(blob)
    eng.import_slot(req, snap.pages, phase=snap.phase,
                    n_prefilled=snap.n_prefilled, generated=snap.generated,
                    reserved_tag=req.rid)
    assert eng.alloc.reserved_pages == 0
    eng.drain(timeout=600)
    return req.future.result(timeout=5)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_a_jax_blob_continues_on_the_port_and_the_reverse(setup, jmig, mode):
    """A slot exported mid-decode by one package's engine resumes on the
    other's and emits the never-migrated greedy stream."""
    max_new = 9
    jsched, jeng = _jax_engine(setup, mode)
    jreq = jsched.submit(_PROMPT, max_new)
    _prefill(jeng, decode_steps=2)
    jblob = jmig.encode_snapshot(jmig.snapshot_slot(jeng, 0))
    jeng.drain(timeout=600)
    ref = jreq.future.result(timeout=5)

    psched, peng = _port_engine(setup, mode)
    preq = psched.submit(_PROMPT, max_new)
    _prefill(peng, decode_steps=3)
    pblob = mig.encode_snapshot(mig.snapshot_slot(peng, 0))
    peng.drain(timeout=600)
    assert preq.future.result(timeout=5) == ref

    s2, e2 = _port_engine(setup, mode)
    assert _resume(s2, e2, jblob, mig.decode_snapshot, max_new) == ref
    assert e2.stats()["migrated_in"] == 1
    assert e2.stats()["prefill_tokens"] == 0
    s3, e3 = _jax_engine(setup, mode)
    assert _resume(s3, e3, pblob, jmig.decode_snapshot, max_new) == ref
    assert e3.stats()["prefill_tokens"] == 0


def test_a_geometry_mismatch_refuses_the_import(setup):
    psched, peng = _port_engine(setup, "int8")
    psched.submit(_PROMPT, 4)
    _prefill(peng)
    snap = mig.snapshot_slot(peng, 0)
    s2, e2 = _port_engine(setup, "bf16")
    with pytest.raises(ValueError, match="incompatible"):
        mig.ServingMigrator._check_geometry(snap, e2)
    req = s2.submit(_PROMPT, 4)
    s2.pop_next()
    with pytest.raises(ValueError, match="pools"):
        e2.import_slot(req, snap.pages, phase="decode", n_prefilled=11,
                       generated=snap.generated)


# ---------------------------------------------------------- kill drills

_PROMPTS = [[2, 3, 4, 2, 3], [9, 10, 9, 10], [5, 6, 7], [11, 3, 7, 1]]
_MAX_NEW = [14, 14, 14, 14]
_SPS = [SamplingParams(temperature=0.9, top_k=5, top_p=0.9, seed=i + 1)
        for i in range(4)]


@pytest.fixture(scope="module")
def refs(setup):
    """The never-evicted streams: one port replica, sampled."""
    _, cfg, _, model = setup
    srv = GenerationServer(model, cfg, mode="bf16", **_SERVER).start()
    try:
        return [srv.submit(p, m, sampling=sp).future.result(timeout=120)
                for p, m, sp in zip(_PROMPTS, _MAX_NEW, _SPS)]
    finally:
        srv.stop()


@pytest.fixture
def hub_events():
    telemetry.reset_hub()
    hub = telemetry.configure_hub()
    events = []
    hub.subscribe(events.append)
    yield events
    telemetry.reset_hub()


def _mid_stream(rep, want):
    slots = [s for s in rep.server.engine.slots if s is not None]
    return len(slots) == want and all(
        s.phase == "decode" and len(s.generated) >= 1
        and not s.req.future.done() for s in slots)


def _run_kill_drill(setup, migrator, watchdog=None):
    """Two unified replicas, four sampled requests (two each); the
    victim's loop is parked from the start and stepped by hand to both
    slots mid-decode, then killed; the router fails over."""
    _, cfg, _, model = setup
    kw = dict(_SERVER, mode="bf16")
    r0 = ServingReplica("mig-0", model, cfg, node_id=0, **kw).start()
    r1 = ServingReplica("mig-1", model, cfg, node_id=1, **kw).start()
    try:
        router = ReplicaRouter([r0, r1], migrator=migrator,
                               watchdog=watchdog)
        with r1.server.paused() as eng1:
            reqs = [router.submit(p, m, sampling=sp)
                    for p, m, sp in zip(_PROMPTS, _MAX_NEW, _SPS)]
            assert [e.replica.name for e in router._entries] == [
                "mig-0", "mig-1", "mig-0", "mig-1"]
            for _ in range(50):
                if _mid_stream(r1, 2):
                    break
                eng1.step()
            assert _mid_stream(r1, 2), "victim never reached mid-stream"
            r1.kill()
        assert not r1.alive and r0.alive
        for r in (reqs[0], reqs[2]):
            r.future.result(timeout=120)
        base_prefill = r0.server.engine.stats()["prefill_tokens"]
        moved = router.poll()
        report = router.reports[-1]
        outs = router.wait_all(timeout=120)
        return r0, r1, reqs, outs, report, base_prefill, moved
    finally:
        r0.stop()
        r1.kill()


def test_kill_drill_migrates_live_with_zero_reprefill(setup, refs,
                                                      hub_events):
    r0, r1, reqs, outs, report, base_prefill, moved = _run_kill_drill(
        setup, mig.ServingMigrator())
    assert report.path == "live"
    assert len(report.placements) == 2 and moved == 2
    assert report.re_prefilled == {} and report.re_routed == {}
    assert report.directive_version >= 1 and report.bytes_moved > 0
    assert report.tokens_saved >= 2 * (3 + 1)
    s0, s1 = r0.server.engine.stats(), r1.server.engine.stats()
    assert s0["prefill_tokens"] == base_prefill
    assert s0["migrated_in"] == 2 and s1["migrated_out"] == 2
    assert outs == refs
    assert r0.server.scheduler.completed == 4
    assert r1.server.scheduler.completed == 0
    assert r0.server.scheduler.re_admitted == 0
    assert r0.server.engine.alloc.reserved_pages == 0
    assert all(r.future.done() for r in reqs)
    recovery = [e for e in hub_events if e.kind == "reshard_recovery"]
    assert recovery and "path=live" in recovery[-1].detail


def _fault_migrator(kind):
    inj = faults.FaultInjector()
    if kind == "torn":
        inj.install(faults.FaultSpec("drop_page", point="serving.transfer"))
        budgets = PhaseBudgets()
    else:
        inj.install(faults.FaultSpec("stall_migration",
                                     point="serving.transfer", delay_s=0.3))
        budgets = PhaseBudgets(transfer_s=0.05)
    return mig.ServingMigrator(budgets=budgets, faults=inj, retries=1)


@pytest.mark.parametrize("kind", ["torn", "stall"])
def test_a_faulted_migration_degrades_to_reprefill(setup, refs, hub_events,
                                                   kind):
    from dlrover_tpu_torch.observability.watchdog import (
        ServingWatchdog, ServingWatchdogConfig,
    )

    wd = ServingWatchdog(ServingWatchdogConfig(fallback_storm=1))
    r0, _, reqs, outs, report, base_prefill, moved = _run_kill_drill(
        setup, _fault_migrator(kind), watchdog=wd)
    # the router hands the watchdog every report: a fallback is a storm
    # of one here
    assert [a.kind for a in wd.anomalies] == ["migration_fallback"]
    assert wd.anomalies[0].replica == "mig-1"
    assert report.path == "fallback"
    assert report.placements == {}
    assert len(report.re_prefilled) == 2 and moved == 2
    s0 = r0.server.engine.stats()
    assert s0["migrated_in"] == 0
    assert s0["prefill_tokens"] > base_prefill
    assert outs == refs
    assert r0.server.scheduler.completed == 4
    assert r0.server.scheduler.re_admitted == 2
    assert all(r.future.done() for r in reqs)
    assert r0.server.engine.alloc.reserved_pages == 0
    recovery = [e for e in hub_events if e.kind == "reshard_recovery"]
    assert recovery and "path=fallback" in recovery[-1].detail


def test_wait_all_backs_off_and_keeps_a_request_deadline(setup):
    _, cfg, _, model = setup
    rep = ServingReplica("strag-0", model, cfg, node_id=0,
                         **dict(_SERVER, mode="bf16")).start()
    try:
        router = ReplicaRouter([rep])
        quick = router.submit(_PROMPTS[0], 2)
        slow = router.submit(_PROMPTS[1], 14)
        polls = {"n": 0}
        orig = router.poll

        def counting_poll():
            polls["n"] += 1
            return orig()

        router.poll = counting_poll
        t0 = time.monotonic()
        assert len(router.wait_all(timeout=120)) == 2
        waited = time.monotonic() - t0
        assert quick.future.done() and slow.future.done()
        assert polls["n"] < max(waited / 0.05, 1.0) / 2 + 2
        with rep.server.paused():
            doomed = router.submit(_PROMPTS[2], 14, deadline_s=0.001)
            with pytest.raises(concurrent.futures.TimeoutError):
                router.wait_all(timeout=120)
            assert not doomed.future.done()
    finally:
        rep.stop()
