"""The port's disaggregated serving fleet against the JAX package.

A fleet of one prefill and one decode replica (the port's
``ReplicaRouter`` over ``ServingReplica``s sharing one model) serves
greedy streams equal to the JAX unified engine's and to the port's
unified server, and its prefill replica ships what the JAX engine in the
prefill role ships: the same handoffs, fragments and wire bytes, cut as
the JAX coordinator cuts them and encoded on the JAX wire (the JAX
fleet itself, threads and compiles, is a slow-tier drill of the JAX
tests). The JAX disagg drills run on the port (sampled streams held
port against port: the port draws by Gumbel-max, not threefry): a torn
fragment retried, a tear past the retries degraded to re-prefill, a
prefill kill resolved exactly once, a decode kill collapsing the fleet
to unified, the prefix-affinity dispatch and its bounce. Then
``retune`` against the JAX engine's, and the serving messages through
the port master against the JAX ``JobManager``. Tiny config in f32;
kills come at a known step of a parked loop, never on a timer.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from dlrover_tpu.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from dlrover_tpu_torch.elastic import faults  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.serving import prefix as prefix_mod  # noqa: E402
from dlrover_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from dlrover_tpu_torch.serving.replica import (  # noqa: E402
    ReplicaRouter, ServingReplica, discover_replicas, refresh_discovery,
)
from dlrover_tpu_torch.serving.scheduler import (  # noqa: E402
    SamplingParams, Scheduler,
)

_KW = dict(n_layer=2, d_model=32, d_ff=64, n_head=4, n_kv_head=2,
           vocab_size=64, max_seq=64, dtype="float32")
_ENGINE = dict(n_slots=4, max_len=32, page_size=4, prefill_chunk=4)
_PROMPTS = [[2, 3, 4, 2, 3], [9, 10, 9, 10], [5, 6, 7], [11, 3, 7, 1],
            [8, 1, 44, 9, 13, 2, 60, 5, 7]]
_MAX_NEW = [10, 10, 10, 10, 8]
_SPS = [SamplingParams(temperature=0.9, top_k=5, top_p=0.9, seed=i + 1)
        for i in range(5)]


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget("tiny", **_KW), get_config("tiny", **_KW)
    params = jdec.init(jax.random.key(0), jcfg)
    model = convert.load_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    return jcfg, cfg, params, model


def _serve(setup, roles, *, sampled=True, router_kw=None, server_kw=None,
           before_wait=None, prefix="dg"):
    """Stand up a port fleet of ``roles``, serve the drill workload and
    tear down; returns what the checks read, gathered before the
    teardown."""
    _, cfg, _, model = setup
    kw = dict(_ENGINE, mode="bf16", idle_sleep=0.001, device="cpu")
    kw.update(server_kw or {})
    reps = [ServingReplica(f"{prefix}{i}-{role}", model, cfg, node_id=i,
                           role=role, **kw).start()
            for i, role in enumerate(roles)]
    router = ReplicaRouter(reps, **(router_kw or {}))
    try:
        sps = _SPS if sampled else [None] * len(_PROMPTS)
        reqs = [router.submit(p, m, sampling=sp)
                for p, m, sp in zip(_PROMPTS, _MAX_NEW, sps)]
        if before_wait is not None:
            before_wait(router, reps, reqs)
        outs = router.wait_all(timeout=120)
        coord = router.coordinator
        return {
            "outs": outs, "reqs": reqs,
            "stats": {r.name: r.server.engine.stats() for r in reps},
            "completed": {r.name: r.server.scheduler.completed
                          for r in reps},
            "degraded": coord.degraded if coord else 0,
            "retried": coord.retried if coord else 0,
            "handoffs_done": coord.completed if coord else 0,
            "fragments": list(coord.fragment_log) if coord else [],
            "disaggregated": router.disaggregated,
            "reserved": {r.name: r.server.engine.alloc.reserved_pages
                         for r in reps},
            "fleet_e2e": router.fleet_latency_ms(),
            "fleet_hists": router.fleet_histograms(),
        }
    finally:
        router.close()
        for r in reps:
            r.stop()


@pytest.fixture(scope="module")
def unified(setup):
    """The port's unified streams, sampled and greedy, in each mode."""
    return {(mode, sampled): _serve(setup, ["unified"], sampled=sampled,
                                    server_kw=dict(mode=mode))["outs"]
            for mode in ("bf16", "int8") for sampled in (True, False)}


@pytest.fixture(scope="module")
def jax_greedy(setup):
    """The JAX unified engine's greedy streams, in each mode."""
    jcfg, _, params, _ = setup
    out = {}
    for mode in ("bf16", "int8"):
        sched = JaxScheduler(replica="jax")
        eng = JaxEngine(params, jcfg, sched, mode=mode, **_ENGINE)
        reqs = [sched.submit(p, m) for p, m in zip(_PROMPTS, _MAX_NEW)]
        eng.drain(timeout=600)
        out[mode] = [r.future.result(timeout=5) for r in reqs]
    return out


@pytest.fixture(scope="module")
def jax_fleet(setup):
    """What the JAX fleet's prefill replica ships for the greedy
    workload, each mode: its engine in the prefill role, stepped here,
    with a sink that cuts the fragments as the JAX coordinator's sink
    does (the full pages each committed chunk adds, the rest at the
    prompt's end) and encodes them on the JAX wire."""
    from dlrover_tpu.serving import migration as jmig

    jcfg, _, params, _ = setup
    out = {}
    for mode in ("bf16", "int8"):
        sched = JaxScheduler(replica="dg0-prefill")
        eng = JaxEngine(params, jcfg, sched, mode=mode, role="prefill",
                        **_ENGINE)
        shipped, blobs, done = {}, [], []

        def sink(i, s, event, eng=eng, shipped=shipped, blobs=blobs,
                 done=done):
            start = shipped.get(s.req.rid, 0)
            final = event == "done"
            stop = (eng.alloc.slot_pages(i) if final
                    else s.n_prefilled // eng.geom.page_size)
            if stop <= start and not final:
                return
            snap = jmig.RequestSnapshot(
                rid=s.req.rid, prompt=[int(t) for t in s.prompt],
                generated=list(s.generated) if final else [],
                n_prefilled=int(s.n_prefilled) if final else 0,
                phase="decode" if final else "prefill",
                max_new_tokens=int(s.req.max_new_tokens),
                seed=int(s.req.sampling.seed), page_start=int(start),
                pages=eng.export_pages(i, start, stop),
                **jmig.geometry_fingerprint(eng.geom))
            blobs.append(len(jmig.encode_snapshot(snap)))
            shipped[s.req.rid] = max(start, stop)
            if final:
                done.append(i)

        eng.handoff_sink = sink
        for p, m in zip(_PROMPTS, _MAX_NEW):
            sched.submit(p, m)
        while sched.queue_depth() or eng.active_slots():
            eng.step()
            while done:  # the handoff landed: the slot goes
                eng.release_slot(done.pop(), reason="handoff_out")
        out[mode] = dict(eng.stats(), fragments=len(blobs),
                         wire_bytes=sum(blobs))
    return out


_PREFILL_KEYS = ("handoffs_out", "prefill_tokens", "prefill_chunks",
                 "tokens_generated", "migrated_out")


@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_the_fleet_serves_the_jax_unified_greedy_streams(
        setup, unified, jax_greedy, jax_fleet, mode, spec_k):
    dis = _serve(setup, ["prefill", "decode"], sampled=False,
                 server_kw=dict(mode=mode, spec_k=spec_k))
    assert dis["disaggregated"]
    assert dis["outs"] == jax_greedy[mode] == unified[(mode, False)]
    pre, dec = dis["stats"]["dg0-prefill"], dis["stats"]["dg1-decode"]
    n = len(_PROMPTS)
    assert pre["handoffs_out"] == n and dec["handoffs_in"] == n
    assert dis["degraded"] == 0 and dis["handoffs_done"] == n
    assert dis["completed"] == {"dg0-prefill": 0, "dg1-decode": n}
    assert dec["prefill_tokens"] == 0 and dec["prefill_chunks"] == 0
    assert all(v == 0 for v in dis["reserved"].values())
    # one fragment a committed page, staged, with its timings
    assert sum(f["bytes"] for f in dis["fragments"]) == pre["handoff_bytes"]
    assert all(f["ms"] >= f["stage_ms"] >= 0 for f in dis["fragments"])
    theirs = jax_fleet[mode]
    assert {k: pre[k] for k in _PREFILL_KEYS} == \
        {k: theirs[k] for k in _PREFILL_KEYS}
    assert len(dis["fragments"]) == theirs["fragments"]
    # the same fragments of the same pages: the blobs differ only in the
    # decimal digits of their payload CRC, as the pages differ in their
    # last bits between the packages (1 to 10 digits each)
    assert abs(pre["handoff_bytes"] - theirs["wire_bytes"]) <= \
        9 * theirs["fragments"]
    assert dec["handoff_bytes"] == 0
    if spec_k:
        assert dec["verify_steps"] > 0 and pre["verify_steps"] == 0


def test_the_sampled_fleet_equals_the_unified_replica(setup, unified):
    dis = _serve(setup, ["prefill", "decode"])
    assert dis["outs"] == unified[("bf16", True)]
    # the fleet's percentiles from the replicas' merged histograms: the
    # first token drawn on the prefill replica, the end on the decode one
    n = len(_PROMPTS)
    assert dis["fleet_e2e"]["n"] == n
    assert dis["fleet_hists"]["ttft"].n == dis["fleet_hists"][
        "handoff"].n == n
    one_shot = _serve(setup, ["prefill", "decode"],
                      router_kw=dict(streaming=False))
    assert one_shot["outs"] == unified[("bf16", True)]
    # one fragment a request when nothing streams
    assert len(one_shot["fragments"]) == len(_PROMPTS)
    assert one_shot["handoffs_done"] == len(_PROMPTS)


def test_a_torn_fragment_is_retried(setup, unified):
    inj = faults.FaultInjector()
    inj.install(faults.FaultSpec("drop_page", point="serving.handoff",
                                 times=1))
    dis = _serve(setup, ["prefill", "decode"], router_kw=dict(faults=inj))
    assert dis["outs"] == unified[("bf16", True)]
    assert dis["retried"] == 1
    assert dis["degraded"] == 0 and dis["handoffs_done"] == len(_PROMPTS)
    assert all(v == 0 for v in dis["reserved"].values())


def test_a_tear_past_the_retries_degrades_to_reprefill(setup, unified):
    inj = faults.FaultInjector()
    inj.install(faults.FaultSpec("drop_page", point="serving.handoff",
                                 times=2))
    dis = _serve(setup, ["prefill", "decode"], router_kw=dict(faults=inj))
    assert dis["outs"] == unified[("bf16", True)]
    assert dis["degraded"] >= 1
    assert sum(dis["completed"].values()) == len(_PROMPTS)
    assert all(r.future.done() for r in dis["reqs"])
    assert all(v == 0 for v in dis["reserved"].values())


def _wait(cond, timeout=60.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def test_a_prefill_kill_is_resolved_exactly_once(setup, unified):
    """The prefill donor dies with one handoff committed and one still
    streaming: the committed request keeps its decode owner; the other
    is cancelled once and re-prefills on the surviving prefill replica
    under its original ticket."""
    _, cfg, _, model = setup
    kw = dict(_ENGINE, mode="bf16", idle_sleep=0.001, device="cpu")
    reps = [ServingReplica(name, model, cfg, node_id=i, role=role,
                           **kw).start()
            for i, (name, role) in enumerate([
                ("dgk0-prefill", "prefill"), ("dgk1-prefill", "prefill"),
                ("dgk2-decode", "decode")])]
    p0, p1, d = reps
    router = ReplicaRouter(reps)
    try:
        with p0.server.paused() as eng0, p1.server.paused():
            reqs = [router.submit(p, m, sampling=sp)
                    for p, m, sp in zip(_PROMPTS[:4], _MAX_NEW, _SPS)]
            assert [e.replica.name for e in router._entries] == [
                "dgk0-prefill", "dgk1-prefill", "dgk0-prefill",
                "dgk1-prefill"]
            # one hand step: prompt 2 (one chunk) finishes and its
            # handoff commits; prompt 0 (two chunks) ships its first
            # page and stays mid-prefill
            eng0.step()
            assert _wait(lambda: d.server.engine.stats()["handoffs_in"]
                         >= 1), "first handoff never committed"
            assert router.coordinator.pending() >= 1
            degraded0 = router.coordinator.degraded
            p0.kill()
        coord = router.coordinator
        router.poll()
        outs = router.wait_all(timeout=120)
        assert outs == unified[("bf16", True)][:4]
        assert all(r.future.done() for r in reqs)
        assert coord.degraded == degraded0 + 1
        assert p1.server.engine.stats()["handoffs_out"] == 3
        assert d.server.engine.stats()["handoffs_in"] == 4
        assert d.server.scheduler.completed == 4
        assert d.server.engine.alloc.reserved_pages == 0
    finally:
        router.close()
        for r in reps:
            r.stop()


def test_a_decode_kill_collapses_the_fleet_to_unified(setup, unified):
    _, cfg, _, model = setup
    kw = dict(_ENGINE, mode="bf16", idle_sleep=0.001, device="cpu")
    p = ServingReplica("dgc0-prefill", model, cfg, node_id=0,
                       role="prefill", **kw).start()
    d = ServingReplica("dgc1-decode", model, cfg, node_id=1, role="decode",
                       **kw).start()
    router = ReplicaRouter([p, d])
    try:
        # staging waits on the held pause, so the kill lands with every
        # handoff in flight
        with d.server.paused():
            reqs = [router.submit(pr, m, sampling=sp)
                    for pr, m, sp in zip(_PROMPTS, _MAX_NEW, _SPS)]
            assert _wait(lambda: p.server.engine.stats()["prefill_tokens"]
                         > 0), "prefill never started"
            d.kill()
        router.poll()
        assert not router.disaggregated
        assert p.server.engine.role == "unified"
        outs = router.wait_all(timeout=120)
        assert outs == unified[("bf16", True)]
        assert all(r.future.done() for r in reqs)
        assert p.server.scheduler.completed == len(_PROMPTS)
        assert d.server.scheduler.completed == 0
    finally:
        router.close()
        p.stop()
        d.stop()


class _HoldSecondFragment(faults.FaultInjector):
    """A fault point that parks the coordinator at its second fragment
    until released: the test then acts between two fragments."""

    def __init__(self):
        super().__init__()
        self.arrived, self.release = threading.Event(), threading.Event()
        self.n = 0

    def at(self, point, rank=-1):
        if point == "serving.handoff":
            self.n += 1
            if self.n == 2:
                self.arrived.set()
                assert self.release.wait(60)


def test_a_decode_death_between_fragments_replays_the_stream(setup):
    """A decode replica dies after it staged a request's first fragment
    and before the next ones are handled, the restart queued at the
    death behind the request's final fragment: the final fragment must
    replay the stream from page 0 on the survivor (the JAX coordinator
    would commit a reservation missing the pages staged on the dead
    replica)."""
    _, cfg, _, model = setup
    kw = dict(_ENGINE, mode="bf16", idle_sleep=0.001, device="cpu")
    prompt, new = [8, 1, 44, 9, 13, 2, 60, 5, 7, 30], 6
    uni = ServingReplica("rp-uni", model, cfg, **kw).start()
    try:
        ref = uni.server.generate(prompt, new, timeout=120)
    finally:
        uni.stop()
    p = ServingReplica("rp-p0", model, cfg, node_id=0, role="prefill",
                       **kw).start()
    d1 = ServingReplica("rp-d1", model, cfg, node_id=1, role="decode",
                        **kw).start()
    d2 = ServingReplica("rp-d2", model, cfg, node_id=2, role="decode",
                        **kw).start()
    gate = _HoldSecondFragment()
    router = ReplicaRouter([p, d1, d2], faults=gate)
    coord = router.coordinator
    try:
        with p.server.paused() as eng0:
            req = router.submit(prompt, new)
            eng0.step()  # chunk 1: page 0 ships to d1 (most free pages)
            assert _wait(lambda: coord._by_rid[req.rid].fragments == 1)
            assert coord._by_rid[req.rid].target is d1
            eng0.step()  # chunk 2: the coordinator parks at its fragment
            assert gate.arrived.wait(60)
            eng0.step()  # the last chunk: the final fragment queues
            assert eng0.slots[0].phase == "handoff"
            d1.kill()
            router.poll()  # the restart queues behind the final one
            assert coord._by_rid[req.rid].target is None
        gate.release.set()
        assert router.wait_all(timeout=120) == [ref]
        assert d2.server.engine.stats()["handoffs_in"] == 1
        assert coord.degraded == 0 and coord.completed == 1
        assert d2.server.engine.alloc.reserved_pages == 0
    finally:
        gate.release.set()
        router.close()
        for r in (p, d1, d2):
            r.stop()


def test_prefix_affinity_skips_prefill_and_a_stale_plan_bounces(setup):
    _, cfg, _, model = setup
    kw = dict(_ENGINE, mode="bf16", idle_sleep=0.001, device="cpu",
              prefix_sharing=True, max_len=64)
    hot = [3, 5, 2, 7, 4, 6, 1, 8, 2, 5, 3, 9]  # 3 full pages
    jobs = [(hot, 40), (hot + [13], 20), (hot + [14], 8)]
    sps = [SamplingParams(temperature=0.9, top_k=5, top_p=0.9, seed=i + 21)
           for i in range(3)]
    uni = ServingReplica("aff-uni", model, cfg, node_id=9, **kw).start()
    try:
        refs = [uni.server.generate(pr, m, sampling=sp, timeout=120)
                for (pr, m), sp in zip(jobs, sps)]
    finally:
        uni.stop()
    p = ServingReplica("aff-prefill", model, cfg, node_id=0,
                       role="prefill", **kw).start()
    d = ServingReplica("aff-decode", model, cfg, node_id=1, role="decode",
                       **kw).start()
    router = ReplicaRouter([p, d])
    try:
        # A seeds the decode replica's index through the prefill pool;
        # once it lands, the decode loop is held at a step boundary (A
        # has 40 tokens to go) so the prefix stays resident while B
        # dispatches
        ra = router.submit(jobs[0][0], jobs[0][1], sampling=sps[0])
        assert _wait(lambda: p.server.engine.stats()["handoffs_out"]
                     == 1 and d.server.engine.stats()["trie_pages"]
                     >= 3), "seeder handoff never landed"
        with d.server.paused():
            assert not ra.future.done()
            rb = router.submit(jobs[1][0], jobs[1][1], sampling=sps[1])
            assert router._by_rid[rb.rid].replica is d
        assert _wait(lambda: d.server.engine.stats()["prefix_hits"] >= 1)
        sd = d.server.engine.stats()
        assert p.server.engine.stats()["handoffs_out"] == 1
        assert sd["prefill_tokens"] <= len(jobs[1][0])
        with d.server.paused() as eng:
            rc = router.submit(jobs[2][0], jobs[2][1], sampling=sps[2])
            assert router._by_rid[rc.rid].replica is d
            eng.trie = prefix_mod.PrefixIndex(eng.geom.page_size)
            eng.alloc.on_free = eng.trie.drop_pages
        assert _wait(lambda: d.server.engine.stats()["affinity_bounced"]
                     >= 1), "stale plan never bounced"
        router.poll()
        assert router.wait_all(timeout=120) == refs
        assert d.server.engine.stats()["affinity_bounced"] == 1
        assert p.server.engine.stats()["handoffs_out"] == 2
        assert all(r.future.done() for r in (ra, rb, rc))
    finally:
        router.close()
        p.stop()
        d.stop()


def test_a_one_sided_fleet_runs_unified(setup, unified):
    dis = _serve(setup, ["prefill"], sampled=True)
    assert not dis["disaggregated"] and dis["outs"] == unified[("bf16",
                                                                True)]


def test_a_decode_replica_refuses_a_raw_re_admission(setup):
    from dlrover_tpu_torch.serving.scheduler import AdmissionError

    _, cfg, _, model = setup
    rep = ServingReplica("rd", model, cfg, role="decode", device="cpu",
                         **_ENGINE)
    req = rep.server.scheduler.submit([1, 2, 3], 2)
    with pytest.raises(AdmissionError, match="prefill pool"):
        rep.server.re_admit(req)


# ----------------------------------------------------------------- retune


def _retune_trace(make, submit, step):
    """Retune an engine through busy and idle states; the applied and
    deferred dicts of each call, and the streams."""
    eng, sched = make()
    reqs = [submit(sched, p, m) for p, m in zip(_PROMPTS[:3], _MAX_NEW)]
    out = []
    step(eng)  # admit and prefill one chunk: slots busy, mid-prefill
    out.append(eng.retune(spec_k=2, page_bucketing=False))
    out.append(eng.retune(prefill_chunk=8, n_slots=2))
    out.append(eng.retune(spec_k=2))
    with pytest.raises(ValueError):
        eng.retune(prefill_chunk=5)
    eng.drain(timeout=600)
    out.append(eng.retune(n_slots=2, prefill_chunk=8, spec_k=0,
                          page_bucketing=True))
    streams = [r.future.result(timeout=5) for r in reqs]
    reqs = [submit(sched, p, m)
            for p, m in zip(_PROMPTS[3:], _MAX_NEW[3:])]
    eng.drain(timeout=600)
    streams += [r.future.result(timeout=5) for r in reqs]
    return out, streams, eng.n_slots, eng.prefill_chunk


def test_retune_applies_and_defers_as_jax_and_keeps_the_streams(
        setup, jax_greedy):
    jcfg, cfg, params, model = setup

    def port():
        sched = Scheduler()
        return ServingEngine(model, cfg, sched, device="cpu", mode="int8",
                             **_ENGINE), sched

    def theirs():
        sched = JaxScheduler()
        return JaxEngine(params, jcfg, sched, mode="int8", **_ENGINE), sched

    def submit(sched, p, m):
        return sched.submit(p, m)

    def step(eng):
        eng.step()

    mine = _retune_trace(port, submit, step)
    ref = _retune_trace(theirs, submit, step)
    assert mine[0] == ref[0]
    assert mine[0][0]["applied"] == {"spec_k": 2, "page_bucketing": False}
    assert "n_slots" in mine[0][1]["deferred"]
    assert mine[0][3]["applied"]["n_slots"] == 2
    assert mine[2:] == ref[2:] == (2, 8)
    assert mine[1] == ref[1] == jax_greedy["int8"]


# ------------------------------------------------- master and discovery


def test_serving_nodes_and_directives_version_as_jax():
    """Role-tagged registration and the four serving messages through
    the port master (its transport, the port client) give the same
    nodes, directives and versions as the JAX ``JobManager`` driven
    alike."""
    from dlrover_tpu.common import messages as jmsgs
    from dlrover_tpu.master.node_manager import JobManager as JManager
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.constants import NodeType
    from dlrover_tpu_torch.master.master import JobMaster

    jm = JManager(num_workers=1)
    master = JobMaster(port=0, num_workers=1)
    master.prepare()
    try:
        clients = {}
        for nid, role in ((3, "prefill"), (4, "decode"), (5, "decode")):
            clients[nid] = MasterClient(master.addr, node_id=nid)
            clients[nid].register_node(node_type=NodeType.SERVING, role=role)
            jm.register_node(jmsgs.NodeMeta(node_type="serving", node_id=nid,
                                            role=role))
        mine = master.job_manager
        for role in (None, "prefill", "decode"):
            assert sorted((n.id, n.name, n.role)
                          for n in mine.serving_nodes(role)) == sorted(
                (n.id, n.name, n.role) for n in jm.serving_nodes(role))
        c = clients[4]
        assert c.get_serving_reshard().version == 0
        assert c.get_serving_scale().version == 0
        for victim, reason in (("serving-4", "evict"), ("serving-3", "")):
            assert c.report_serving_eviction(victim, in_flight=2,
                                             deadline_s=7.0, reason=reason)
            jm.plan_serving_reshard(victim, deadline_s=7.0, reason=reason)
            d = c.get_serving_reshard()
            assert {"version": d.version, "victim": d.victim,
                    "survivors": d.survivors, "deadline_s": d.deadline_s,
                    "reason": d.reason} == jm.get_serving_reshard()
        for role, n0, n1 in (("prefill", 1, 2), ("decode", 2, 1),
                             ("prefill", 2, 1)):
            assert c.report_serving_scale(role, "out" if n1 > n0 else "in",
                                          n0, n1, signal="ttft_regression")
            jm.plan_serving_scale(role, n1, reason="ttft_regression")
        for role in ("", "prefill", "decode", "unified"):
            d = c.get_serving_scale(role)
            want = jm.get_serving_scale(role)
            assert d.version == want["version"]
            if want["version"]:
                assert (d.role, d.target, d.reason) == (
                    want["role"], want["target"], want["reason"])
        for cl in clients.values():
            cl.close()
    finally:
        master.stop()


def test_replicas_register_role_tagged_and_are_discovered(setup):
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import JobMaster

    _, cfg, _, model = setup
    master = JobMaster(port=0, num_workers=1)
    master.prepare()
    reps = []
    try:
        for i, role in enumerate(("prefill", "decode")):
            reps.append(ServingReplica(
                f"reg{i}", model, cfg, node_id=10 + i, role=role,
                master_addr=master.addr, device="cpu", **_ENGINE).start())
        roles = {n.id: n.role for n in master.job_manager.serving_nodes()}
        assert roles == {10: "prefill", 11: "decode"}
        client = MasterClient(master.addr, node_id=99)
        assert discover_replicas(client, ["reg0", "reg9"]) is None
        found = discover_replicas(client, ["reg0", "reg1"])
        assert found["reg1"] == {"name": "reg1", "node_id": 11,
                                 "role": "decode"}
        assert set(refresh_discovery(client, ["reg0", "reg1", "reg9"],
                                     known={"reg0": {}})) == {"reg1"}
        client.close()
    finally:
        for r in reps:
            r.stop()
        master.stop()
