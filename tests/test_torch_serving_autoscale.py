"""The port's serving autoscaler, serving watchdog and healthcheck
sections against the JAX package.

Each scenario of the JAX tests' synthetic signals (a fake clock, signal
dicts, no replica) runs on both packages' ``ServingAutoScaler`` and must
give the same decisions, latches and clocks; the ``ServingWatchdog``
raises the same anomalies with the same captures on the same records;
a flight-recorder file the port writes replays to the same serving and
scale sections under the JAX ``diagnose``; the histogram window is the
JAX one. Then the port's live drill (slow, as the repository's marker
lint asks of every autoscaler fleet drill): a queue-depth breach on a
parked one-replica fleet scales out onto a warm spare, which takes
dispatches, and after the clear windows a planned scale-in drains the
victim over the live-migration wire, zero lost and zero re-prefilled.
"""

import json
import os
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dlrover_tpu.master import serving_autoscaler as jsa  # noqa: E402
from dlrover_tpu.observability import healthcheck as jhc  # noqa: E402
from dlrover_tpu.observability import histogram as jhist  # noqa: E402
from dlrover_tpu.observability import telemetry as jtel  # noqa: E402
from dlrover_tpu.observability import watchdog as jwd  # noqa: E402
from dlrover_tpu_torch.master import serving_autoscaler as tsa  # noqa: E402
from dlrover_tpu_torch.observability import healthcheck as thc  # noqa: E402
from dlrover_tpu_torch.observability import histogram as thist  # noqa: E402
from dlrover_tpu_torch.observability import telemetry as ttel  # noqa: E402
from dlrover_tpu_torch.observability import watchdog as twd  # noqa: E402

JAX = types.SimpleNamespace(sa=jsa, tel=jtel, wd=jwd, hist=jhist, hc=jhc)
PORT = types.SimpleNamespace(sa=tsa, tel=ttel, wd=twd, hist=thist, hc=thc)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeRouter:
    disaggregated = False

    def live_replicas(self, role=None):
        return []


class FakePlanner:
    def __init__(self):
        self.calls = []
        self.v = 41

    def plan_serving_scale(self, role, target, reason=""):
        self.calls.append((role, target, reason))
        self.v += 1
        return self.v


def _scaler(pkg, clock, **cfg_kw):
    cfg_kw.setdefault("p99_target_ms", 100.0)
    cfg_kw.setdefault("min_window_n", 4)
    cfg_kw.setdefault("cooldown_s", 10.0)
    planner = cfg_kw.pop("planner", None)
    return pkg.sa.ServingAutoScaler(
        FakeRouter(), pkg.sa.ServingScalerConfig(**cfg_kw), clock=clock,
        job_manager=planner)


def _sig(role="unified", n=16, p99=50.0, ttft=0.0, tpot=0.0, queue=0,
         occ=0.0, n_replicas=1):
    return {"roles": {role: {
        "n": n, "p99_ms": p99, "ttft_p99_ms": ttft, "tpot_p99_ms": tpot,
        "queue_depth": queue, "new_drops": 0, "occupancy": occ,
        "n_replicas": n_replicas}}}


def _two_roles(**over):
    roles = {
        "prefill": dict(n=16, p99_ms=40.0, ttft_p99_ms=30.0,
                        tpot_p99_ms=0.0, queue_depth=1, new_drops=0,
                        occupancy=0.3, n_replicas=1),
        "decode": dict(n=16, p99_ms=40.0, ttft_p99_ms=0.0,
                       tpot_p99_ms=5.0, queue_depth=1, new_drops=0,
                       occupancy=0.3, n_replicas=1),
    }
    for role, kv in over.items():
        roles[role].update(kv)
    return {"roles": roles}


def _rec_fields(rec):
    d = dict(vars(rec)) if not hasattr(rec, "__dataclass_fields__") else {
        k: getattr(rec, k) for k in rec.__dataclass_fields__}
    d.pop("ts", None)
    return d


def _trace(sc, clock, steps, apply=False):
    """Evaluate ``steps`` [(t, signals)], applying actionable decisions
    when ``apply``; the decisions, latches and clocks of every tick."""
    out = []
    for t, sig in steps:
        clock.t = t
        d = sc.evaluate(sig)
        rec = None
        if d is not None and apply:
            rec = sc.apply(d)
        elif d is not None and d["direction"]:
            sc._last_decision_t[d["role"]] = t
        out.append((d, rec and _rec_fields(rec), dict(sc._latched),
                    dict(sc._clear_streak), sc.last_restore_s,
                    sc.last_reaction_s))
    return out


def _scenario(name, pkg):
    clock = FakeClock()
    if name == "slo_breach":
        sc = _scaler(pkg, clock)
        return _trace(sc, clock, [(5.0, _sig(p99=150.0))], apply=True)
    if name == "at_max":
        sc = _scaler(pkg, clock, max_replicas=2)
        return _trace(sc, clock, [(0.0, _sig(p99=150.0, n_replicas=2))])
    if name == "cooldown":
        sc = _scaler(pkg, clock, max_replicas=4)
        return _trace(sc, clock, [(0.0, _sig(p99=150.0)),
                                  (5.0, _sig(p99=150.0, n_replicas=2)),
                                  (11.0, _sig(p99=150.0, n_replicas=2))],
                      apply=True)
    if name == "priority":
        sc = _scaler(pkg, clock)
        return _trace(sc, clock, [(0.0, _sig(p99=150.0, occ=0.99))])
    if name == "thin_window":
        sc = _scaler(pkg, clock, min_window_n=8)
        return _trace(sc, clock, [(0.0, _sig(p99=150.0, n=3))])
    if name == "hysteresis":
        sc = _scaler(pkg, clock, max_replicas=2)
        return _trace(sc, clock, [(1.0, _sig(p99=150.0)),
                                  (2.0, _sig(p99=90.0, n_replicas=2)),
                                  (4.5, _sig(p99=70.0, n_replicas=2))],
                      apply=True)
    if name == "shrink":
        sc = _scaler(pkg, clock, shrink_after_clear=3, cooldown_s=1.0)
        return _trace(sc, clock, [(10.0 + i, _sig(p99=20.0, n_replicas=2))
                                  for i in range(4)])
    if name == "floor_and_gate":
        sc = _scaler(pkg, clock, shrink_after_clear=1, cooldown_s=0.0)
        tr = _trace(sc, clock, [(100.0 + i, _sig(p99=20.0))
                                for i in range(5)])
        sc._on_gate("slo_breach", True, None)
        return tr + _trace(sc, clock, [(106.0, _sig(p99=20.0,
                                                    n_replicas=2))])
    if name == "oscillating":
        sc = _scaler(pkg, clock, max_replicas=8, shrink_after_clear=2)
        return _trace(sc, clock, [
            (i * 0.25, _sig(p99=150.0 if i % 2 == 0 else 70.0))
            for i in range(100)])
    if name == "ttft_prefill":
        sc = _scaler(pkg, clock, p99_target_ms=0.0, ttft_target_ms=20.0)
        return _trace(sc, clock, [(0.0, _two_roles(
            prefill={"ttft_p99_ms": 80.0}))])
    if name == "tpot_decode":
        sc = _scaler(pkg, clock, p99_target_ms=0.0, tpot_target_ms=4.0)
        return _trace(sc, clock, [(0.0, _two_roles(
            decode={"tpot_p99_ms": 9.0}))])
    if name == "pages_decode":
        sc = _scaler(pkg, clock, p99_target_ms=0.0)
        return _trace(sc, clock, [(0.0, _two_roles(
            decode={"occupancy": 0.97}))])
    if name == "queue_prefill":
        sc = _scaler(pkg, clock, p99_target_ms=0.0, queue_depth_high=4)
        return _trace(sc, clock, [(0.0, _two_roles(
            prefill={"queue_depth": 9}))])
    if name == "role_bounds":
        sc = _scaler(pkg, clock, p99_target_ms=0.0, queue_depth_high=4,
                     max_replicas=4, role_max={"prefill": 1})
        return _trace(sc, clock, [(0.0, _two_roles(
            prefill={"queue_depth": 9}))])
    if name == "gate_edge":
        sc = _scaler(pkg, clock)
        wd = pkg.wd.ServingWatchdog(
            pkg.wd.ServingWatchdogConfig(p99_target_ms=100.0), clock=clock)
        wd.subscribe(sc._on_gate)
        clock.t = 2.0
        wd.observe(pkg.tel.ServingRecord(replica="rep-0", completed=20,
                                         p99_ms=150.0))
        return _trace(sc, clock, [(3.5, _sig(p99=150.0))])
    if name == "versioned":
        planner = FakePlanner()
        sc = _scaler(pkg, clock, planner=planner)
        tr = _trace(sc, clock, [(0.0, _sig(p99=150.0)),
                                (1.0, _sig(p99=10.0, n_replicas=2))],
                    apply=True)
        return tr + [planner.calls]
    raise KeyError(name)


SCENARIOS = ["slo_breach", "at_max", "cooldown", "priority", "thin_window",
             "hysteresis", "shrink", "floor_and_gate", "oscillating",
             "ttft_prefill", "tpot_decode", "pages_decode", "queue_prefill",
             "role_bounds", "gate_edge", "versioned"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_the_scaler_decides_as_jax(name):
    mine, theirs = _scenario(name, PORT), _scenario(name, JAX)
    assert mine == theirs
    assert tsa.SCALE_SIGNALS == jsa.SCALE_SIGNALS
    if name == "slo_breach":
        d = mine[0][0]
        assert (d["direction"], d["role"], d["signal"], d["n_after"]) == (
            "out", "unified", "slo_breach", 2)
    if name == "versioned":
        assert mine[0][1]["version"] == 42 and mine[1][1]["version"] == 0


def test_a_scale_decision_record_reads_back_in_jax():
    rec = ttel.ScaleDecisionRecord(
        role="decode", direction="out", signal="tpot_breach", value=9.0,
        target=4.0, n_before=1, n_after=2, version=7, reaction_s=0.31,
        replica="spare-0", reason="tpot 9>4", ts=1.0)
    back = jtel.from_json(rec.to_json())
    assert type(back).__name__ == "ScaleDecisionRecord"
    assert _rec_fields(back) == _rec_fields(rec)
    assert ttel.from_json(back.to_json()) == rec
    assert thc._scale_section({}) == {}


def test_the_histogram_window_is_the_jax_window():
    prev, jprev = thist.LatencyHistogram(), jhist.LatencyHistogram()
    for v in (10.0, 10.0, 10.0, 10.0):
        prev.record(v)
        jprev.record(v)
    cur, jcur = prev.copy(), jprev.copy()
    for v in (500.0, 500.0, 7.0):
        cur.record(v)
        jcur.record(v)
    win = thist.histogram_delta(cur, prev)
    assert win.to_dict() == jhist.histogram_delta(jcur, jprev).to_dict()
    assert win.n == 3 and win.percentile(99.0) > 400.0
    assert thist.histogram_delta(cur, None).n == cur.n
    with pytest.raises(ValueError):
        thist.histogram_delta(cur, thist.LatencyHistogram(sub_bits=3))
    merged = thist.merge_histograms([prev, cur])
    assert merged.to_dict() == jhist.merge_histograms([jprev, jcur]).to_dict()
    assert thist.merge_histograms([]) is None


# ------------------------------------------------------------ watchdog


def _records(pkg):
    """A record stream crossing every serving gate in and out."""
    R = pkg.tel.ServingRecord
    return [
        R(replica="rep-0", completed=20, p99_ms=150.0, ttft_p99_ms=30.0),
        R(replica="rep-0", completed=20, p99_ms=150.0, ttft_p99_ms=90.0),
        R(replica="rep-0", completed=21, p99_ms=50.0, ttft_p99_ms=20.0,
          draft_tokens=100, spec_accept_rate=0.05),
        R(replica="rep-0", completed=22, p99_ms=50.0, shed=3, rejected=2,
          timed_out=2, poisoned=1, draft_tokens=100, spec_accept_rate=0.5),
        R(replica="rep-0", completed=3, p99_ms=500.0),
        R(replica="rep-1", completed=30, p99_ms=120.0, ttft_p99_ms=70.0,
          shed=20),
    ]


class _Report:
    def __init__(self, path, n):
        self.path = path
        self.re_prefilled = {f"r{i}": "x" for i in range(n)}


def _watch(pkg, capture_dir):
    clock = FakeClock()
    cfg = pkg.wd.ServingWatchdogConfig(
        node_id=3, capture_dir=capture_dir, p99_target_ms=100.0,
        ttft_target_ms=60.0, min_capture_interval_s=0.0, max_captures=4)
    wd = pkg.wd.ServingWatchdog(cfg, clock=clock,
                                snapshot_fn=lambda: {"engine": "frozen"})
    edges = []
    wd.subscribe(lambda k, b, r: edges.append(
        (k, b, r.replica if r is not None else None)))
    fired = []
    for i, rec in enumerate(_records(pkg)):
        clock.t = float(i)
        fired.append([(a.kind, a.step, a.node_id, a.value, a.detail,
                       a.replica, os.path.basename(a.capture))
                      for a in wd.observe(rec)])
    for path, n in (("fallback", 1), ("fallback", 2), ("fallback", 1),
                    ("live", 0), ("fallback", 1)):
        a = wd.observe_migration(_Report(path, n), replica="rep-1")
        fired.append(a and (a.kind, a.value, a.detail, a.replica))
    caps = {}
    for a in wd.anomalies:
        if a.capture:
            with open(a.capture) as f:
                doc = json.load(f)
            doc["record"].pop("ts", None)
            caps[os.path.basename(a.capture)] = doc
    return fired, edges, caps


def test_the_serving_watchdog_fires_as_jax(tmp_path):
    mine = _watch(PORT, str(tmp_path / "port"))
    theirs = _watch(JAX, str(tmp_path / "jax"))
    assert mine == theirs
    assert twd.SERVING_ANOMALY_KINDS == jwd.SERVING_ANOMALY_KINDS
    kinds = {f[0] for tick in mine[0][:6] for f in tick}
    assert kinds == {"slo_breach", "ttft_regression",
                     "spec_accept_collapse", "shed_storm"}
    assert mine[0][7][0] == "migration_fallback"
    assert len(mine[2]) == 4  # the capture budget


# --------------------------------------------------------- healthcheck


def _flight_file(path):
    """A flight recorder the port writes: replicas of both roles with
    their histograms, a serving anomaly and an autoscale trail."""
    hub_records = []
    hists = {}
    for name, role, base in (("p0", "prefill", 40.0), ("d0", "decode", 5.0),
                             ("d1", "decode", 9.0)):
        h = {k: thist.LatencyHistogram() for k in
             ("e2e", "ttft", "tpot", "queue_wait", "handoff")}
        rng = np.random.default_rng(len(hists))
        for v in rng.random(20) * base + base:
            for k in h:
                h[k].record(float(v))
        hists[name] = h
        for completed in (10, 20):
            hub_records.append(ttel.ServingRecord(
                replica=name, role=role, completed=completed, admitted=24,
                shed=1, p99_ms=base * 3, ttft_p99_ms=base * 2,
                tpot_p99_ms=base / 2, queue_wait_p99_ms=1.5,
                tokens_per_s=100.0 + completed, handoffs_in=4 if role ==
                "decode" else 0, handoffs_out=8 if role == "prefill" else 0,
                handoff_ms_p99=12.5,
                hists=json.dumps({k: v.to_dict() for k, v in h.items()},
                                 sort_keys=True)))
    hub_records.append(ttel.AnomalyRecord(
        kind="ttft_regression", step=3, node_id=0, value=80.0,
        detail="ttft_p99=80ms target=60ms", replica="p0"))
    for i, (role, direction, sig, n0, n1) in enumerate((
            ("prefill", "out", "ttft_regression", 1, 2),
            ("prefill", "", "clear", 2, 2),
            ("prefill", "in", "planned", 2, 1))):
        hub_records.append(ttel.ScaleDecisionRecord(
            role=role, direction=direction, signal=sig, value=80.0,
            target=60.0, n_before=n0, n_after=n1, version=i + 1 if
            direction else 0, reaction_s=0.1 * (i + 1),
            replica="p1" if direction else "", reason=f"{sig} reason",
            ts=float(i)))
    sink = ttel.JsonlSink(str(path))
    for rec in hub_records:
        sink.emit(rec)
    sink.close()


def test_the_healthcheck_serving_and_scale_sections_are_jax_s(tmp_path):
    path = tmp_path / "flight.jsonl"
    _flight_file(path)
    mine = thc.diagnose(thc.load_records(str(path)))
    theirs = jhc.diagnose(jhc.load_records(str(path)))
    for key in ("serving", "scale_decisions", "anomalies"):
        assert mine[key] == theirs[key], key
    assert mine["serving"]["roles"]["decode"]["replicas"] == 2
    assert mine["scale_decisions"]["final_size"] == {"prefill": 1}
    assert thc._slow_role(mine["serving"], "ttft_regression") == "prefill"
    assert thc._slow_role(mine["serving"], "slo_breach") == \
        jhc._slow_role(theirs["serving"], "slo_breach")
    mine_lines = thc.format_report(mine).splitlines()
    theirs_lines = jhc.format_report(theirs).splitlines()
    for line in theirs_lines:
        if line.startswith(("  p0", "  d0", "  d1", "  roles:", "  fleet ",
                            "autoscale:", "  v", "  prefill pool",
                            "  slow role")):
            assert line in mine_lines, line


# ------------------------------------------------- the port's live drill


@pytest.mark.slow
def test_a_live_fleet_scales_out_then_drains_in_with_zero_loss():
    import torch  # noqa: F401

    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.serving.migration import ServingMigrator
    from dlrover_tpu_torch.serving.replica import (
        ReplicaRouter, ServingReplica,
    )
    from dlrover_tpu_torch.serving.server import GenerationServer

    cfg = get_config("tiny", n_layer=2, d_model=32, d_ff=64, n_head=4,
                     vocab_size=32, max_seq=64, dtype="float32")
    model = decoder.init(cfg, seed=0, device="cpu")
    kw = dict(n_slots=4, max_len=32, page_size=4, mode="bf16",
              prefill_chunk=4, idle_sleep=0.001, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, 32, size=5)))
               for _ in range(8)]
    ref_srv = GenerationServer(model, cfg, **kw).start()
    try:
        refs = [ref_srv.generate(p, 12, timeout=120) for p in prompts]
    finally:
        ref_srv.stop()
    r0 = ServingReplica("as-0", model, cfg, node_id=0, **kw).start()
    spare = ServingReplica("as-spare", model, cfg, node_id=9, **kw).start()
    router = ReplicaRouter([r0], migrator=ServingMigrator())
    scaler = tsa.ServingAutoScaler(
        router, tsa.ServingScalerConfig(queue_depth_high=2, cooldown_s=0.0,
                                        max_replicas=2,
                                        shrink_after_clear=2),
        provision_fn=lambda role: spare)
    try:
        # the burst queues on the parked replica: a queue-depth breach
        with r0.server.paused():
            reqs = [router.submit(p, 12) for p in prompts[:6]]
            rec = scaler.step()
        assert (rec.direction, rec.signal, rec.n_after, rec.replica) == (
            "out", "queue_depth", 2, "as-spare")
        assert len(router.live_replicas()) == 2
        # the joiner took queued work (rebalanced) and new dispatches
        reqs += [router.submit(p, 12) for p in prompts[6:]]
        outs = router.wait_all(timeout=120)
        assert outs == refs
        assert spare.server.scheduler.completed > 0
        # clear, then two clear windows: a planned scale-in
        trail = [scaler.step() for _ in range(3)]
        assert [(r.direction, r.signal) for r in trail if r] == [
            ("", "clear"), ("in", "planned")]
        victim = trail[-1].replica
        assert len(router.live_replicas()) == 1
        assert router.is_detached(next(r for r in (r0, spare)
                                       if r.name == victim))
        done = sum(r.server.scheduler.completed for r in (r0, spare))
        assert done == len(prompts)
        assert r0.server.scheduler.re_admitted == 0
        assert router.poll() == 0
    finally:
        router.close()
        for r in (r0, spare):
            r.stop()


def test_a_server_feeds_its_watchdog_the_engine_snapshot(tmp_path):
    """``GenerationServer(watchdog=...)`` observes every published
    record; a capture holds the engine's ``observability_snapshot``,
    whose sections are the JAX engine's."""
    from dlrover_tpu.models import decoder as jdec
    from dlrover_tpu.models.config import get_config as jget
    from dlrover_tpu.serving.engine import ServingEngine as JaxEngine
    from dlrover_tpu.serving.scheduler import Scheduler as JaxScheduler
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.serving.server import GenerationServer

    kw = dict(n_layer=2, d_model=32, d_ff=64, n_head=4, vocab_size=32,
              max_seq=64, dtype="float32")
    cfg = get_config("tiny", **kw)
    model = decoder.init(cfg, seed=0, device="cpu")
    wd = twd.ServingWatchdog(twd.ServingWatchdogConfig(
        capture_dir=str(tmp_path), p99_target_ms=1e-3, min_completed=4))
    srv = GenerationServer(model, cfg, watchdog=wd, device="cpu",
                           n_slots=2, max_len=32, page_size=4,
                           prefill_chunk=4, publish_every=0.0).start()
    try:
        for i in range(5):
            srv.generate([1 + i, 2, 3], 3, timeout=60)
    finally:
        srv.stop()
    assert [a.kind for a in wd.anomalies] == ["slo_breach"]
    with open(wd.anomalies[0].capture) as f:
        doc = json.load(f)
    jcfg = jget("tiny", **kw)
    jeng = JaxEngine(jdec.init(jax.random.key(0), jcfg), jcfg,
                     JaxScheduler(), n_slots=2, max_len=32, page_size=4,
                     prefill_chunk=4)
    want = jeng.observability_snapshot()
    assert set(doc["engine"]) == set(want)
    for k in ("phase_split", "scheduler", "allocator", "handoff", "prefix"):
        assert set(doc["engine"][k]) == set(want[k]), k
    assert doc["engine"]["allocator"]["n_pages"] == want["allocator"][
        "n_pages"]
    assert doc["record"]["replica"] == srv.replica
