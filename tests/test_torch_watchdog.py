"""The port's watchdog, aggregator, healthcheck replay, telemetry records
and numeric checker against the JAX package's.

Mirrors ``tests/test_observability.py``'s watchdog, aggregator, schema
and replay cases:

- the same per-step metric streams go to the JAX ``Watchdog`` and the
  port's under one fake clock — NaN steps (every step reserving a
  capture while the budget and its interval allow), a loss spike after
  the warm-up, a step-time regression against a plan, an explicit
  straggler — and their ``AnomalyRecord``s are the same field for field
  (kind, step, node, value, detail, capture path, the budget's
  refusals); the capture file holds the same breakdown;
- ``verdict_for`` over a table, and ``HealthAggregator`` on each
  package's hub: the same ``HealthSummary`` for one rank and for every
  rank reporting;
- every record type the two packages share round-trips through JSON in
  both directions (JAX's ``to_json`` into the port's ``from_json``, the
  port's into JAX's), the Brain's ``TuningPlan`` and ``JobMetrics``
  (registered by each healthcheck's import of its ``cluster/brain.py``)
  and ``OverlapDriftRecord`` among them;
- a flight-recorder file the port's ``JsonlSink`` wrote (torn tail and
  foreign line included) replays through both ``healthcheck.diagnose``
  functions to the same report for the sections the port has, and the
  same ``format_report`` text; the port's CLI exits 1 on it;
- ``NumericChecker.compare``/``allclose`` and ``check_finite`` name and
  measure the leaves as JAX's do.
"""

import dataclasses
import json

import numpy as np
import pytest

from dlrover_tpu.observability import healthcheck as jhc
from dlrover_tpu.observability import numeric as jnum
from dlrover_tpu.observability import runtime_timer as jrt
from dlrover_tpu.observability import telemetry as jtel
from dlrover_tpu.observability import watchdog as jwd
from dlrover_tpu_torch.observability import healthcheck as thc
from dlrover_tpu_torch.observability import numeric as tnum
from dlrover_tpu_torch.observability import runtime_timer as trt
from dlrover_tpu_torch.observability import telemetry as ttel
from dlrover_tpu_torch.observability import watchdog as twd


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stream():
    """(step, metrics, step_time_s, planned_s, clock advance)."""
    out = []
    for step in range(1, 31):
        m = {"loss": 2.0 + 0.01 * (step % 3), "sent_nonfinite": 0.0,
             "sent_loss_nonfinite": 0.0, "sent_update_ratio": 1e-3}
        if step in (5, 6, 19, 27):
            m["sent_nonfinite"] = 12.0 if step != 19 else 0.0
            m["sent_loss_nonfinite"] = 1.0
            m["sent_sanitizer_skips"] = 2.0
        if step == 24:
            m["loss"] = 9.5  # a spike past the warm-up
        if step == 12:
            m["sent_fp8_sat"] = 0.75
        time_s = 0.3 if step in (9, 10) else 0.1
        out.append((step, m, time_s, 0.1 if step > 2 else 0.0, 20.0))
    return out


def _watch(mod, tmp, clock):
    cfg = mod.WatchdogConfig(node_id=3, capture_dir=str(tmp),
                             spike_min_iter=10, spike_min_loss=3.0,
                             min_capture_interval_s=50.0, max_captures=3)
    return mod.Watchdog(cfg, clock=clock)


def _fields(rec):
    return {k: v for k, v in dataclasses.asdict(rec).items() if k != "ts"}


def test_watchdog_records_equal_jax_under_a_fake_clock(tmp_path):
    jc, tc = Clock(), Clock()
    jw, tw = _watch(jwd, tmp_path, jc), _watch(twd, tmp_path, tc)
    for step, m, time_s, planned, dt in _stream():
        jc.t += dt
        tc.t += dt
        jr = jw.observe(step, dict(m), step_time_s=time_s,
                        planned_step_time_s=planned)
        tr = tw.observe(step, dict(m), step_time_s=time_s,
                        planned_step_time_s=planned)
        assert [_fields(r) for r in tr] == [_fields(r) for r in jr], step
        assert tw.capture_pending == jw.capture_pending
        if step in (7, 20):  # the trainer's forced sample lands
            rows = [("k1", 30.0, 2), ("k2", 10.0, 1)]
            jb = [jrt.OpTime(n, us, c, us / 40.0) for n, us, c in rows]
            tb = [trt.OpTime(n, us, c, us / 40.0) for n, us, c in rows]
            jp = jw.write_capture(step, jb)
            tp = tw.write_capture(step, tb)
            assert tp == jp
    jr = jw.observe_straggler(30, 4, 2.5)
    tr = tw.observe_straggler(30, 4, 2.5)
    assert _fields(tr) == _fields(jr)
    kinds = [r.kind for r in tw.anomalies]
    assert set(kinds) == set(twd.ANOMALY_KINDS)
    caps = [r.capture for r in tw.anomalies if r.capture]
    assert len(caps) == 3  # the budget: three captures, then refusals
    assert [_fields(r) for r in tw.anomalies] == [
        _fields(r) for r in jw.anomalies]


def test_a_written_capture_holds_the_jax_capture(tmp_path):
    docs = []
    for mod, rt in ((jwd, jrt), (twd, trt)):
        w = _watch(mod, tmp_path / mod.__name__.split(".")[0], Clock())
        w.observe(4, {"sent_nonfinite": 1.0})
        path = w.write_capture(5, [rt.OpTime("op", 8.0, 2, 1.0)], block=1)
        assert path and not w.capture_pending
        assert w.write_capture(6, []) == ""  # nothing pending
        docs.append(json.loads(open(path).read()))
    jdoc, tdoc = docs
    jdoc.pop("plan_diff")  # the overlap plan: ROADMAP A20
    assert tdoc == jdoc


@pytest.mark.parametrize("n,world", [(1, 4), (4, 4), (2, 4), (1, 0),
                                     (3, 0), (5, 4)])
def test_verdict_for_equals_jax(n, world):
    assert twd.verdict_for(n, world) == jwd.verdict_for(n, world)


@pytest.mark.parametrize("ranks", [(2,), (0, 1, 2, 3)])
def test_health_aggregator_equals_jax(ranks):
    outs = []
    for mod, tel in ((jwd, jtel), (twd, ttel)):
        hub = tel.TelemetryHub()
        seen = []
        hub.subscribe(seen.append, types=("HealthSummary",))
        agg = mod.HealthAggregator(hub=hub, world=4)
        for i, r in enumerate(ranks):
            hub.publish(tel.AnomalyRecord(kind="nan_grads", step=7 - i,
                                          node_id=r, ts=1.0))
            hub.publish(tel.AnomalyRecord(kind="nan_grads", step=2,
                                          node_id=r, ts=1.0))  # known rank
        hub.publish(tel.StragglerRecord(node_id=1, step=3, ts=1.0))
        outs.append(([_fields(s) for s in seen],
                     {k: _fields(v) for k, v in agg.summaries.items()}))
    assert outs[1] == outs[0]
    verdict = outs[1][1]["nan_grads"]["verdict"]
    assert verdict == ("suspect_data_or_hardware" if len(ranks) == 1
                       else "suspect_model_or_config")


def _shared_records(mod):
    return [
        mod.StepRecord(step=2, loss=1.25, step_time_s=0.5, ts=1.0),
        mod.CollectiveRecord(op="all-reduce", bytes=8, wire_dtype="f32",
                             ts=1.0),
        mod.CheckpointRecord(kind="restore", step=3, tier="replica", ts=2.0),
        mod.KernelSample(step=5, op="flash_fwd_wgmma_kernel", us=90.5,
                         share=0.25, block=4, ts=3.0),
        mod.PlanRecord(config="llama", planned_step_time_s=0.27, ts=4.0),
        mod.ElasticEvent(kind="node_down", node_id=1, ts=5.0),
        mod.NumericEvent(kind="loss_spike", step=9, value=9.5, ts=6.0),
        mod.StragglerRecord(node_id=1, lag_steps=3, ts=7.0),
        mod.ResourceRecord(node_id=0, cpu_percent=50.0, ts=8.0),
        mod.AnomalyRecord(kind="nan_grads", step=4, capture="/c.json",
                          ts=9.0),
        mod.HealthSummary(kind="nan_grads", ranks="0,1", n_ranks=2,
                          world=2, verdict="suspect_model_or_config",
                          ts=10.0),
        mod.ServingRecord(replica="r0", completed=5, hists="{}", ts=11.0),
        mod.OverlapDriftRecord(step=6, planned_exposed_us=40.0,
                               measured_collective_us=90.0, drift_us=50.0,
                               drift_frac=0.55, ts=12.0),
        mod.record_types()["TuningPlan"](
            version=3, origin="revision", signal="oom", knob="batch_size",
            reason="oom at remat=full; batch 4→2", batch_size=2, ts=13.0),
        mod.record_types()["JobMetrics"](
            job_name="j", job_kind="gpt", timestamp=5.0, worker_num=2,
            steps_per_sec=1.5, finished=True, ts=14.0),
        mod.ScaleDecisionRecord(role="decode", direction="out",
                                signal="tpot_breach", value=9.0, target=4.0,
                                n_before=1, n_after=2, version=7,
                                reaction_s=0.31, replica="spare-0",
                                reason="tpot 9>4", ts=15.0),
    ]


def test_every_shared_record_round_trips_both_ways():
    port_types = ttel.record_types()
    shared = set(port_types) & set(jtel.record_types())
    mine, theirs = _shared_records(ttel), _shared_records(jtel)
    assert {type(r).__name__ for r in mine} == shared
    for a, b in zip(mine, theirs):
        assert a.to_json() == b.to_json()
        assert dataclasses.asdict(ttel.from_json(b.to_json())) == \
            dataclasses.asdict(a)
        assert dataclasses.asdict(jtel.from_json(a.to_json())) == \
            dataclasses.asdict(b)


def _flight(tmp_path):
    """A port JsonlSink file: two ranks' steps, anomalies and events, a
    foreign line and a torn tail."""
    path = tmp_path / "telemetry-worker.jsonl"
    sink = ttel.JsonlSink(str(path))
    for step in range(1, 6):
        sink.emit(ttel.StepRecord(step=step, loss=3.0 - 0.1 * step, ts=1.0))
    for rec in (
            ttel.AnomalyRecord(kind="nan_grads", step=4, node_id=1,
                               detail="nonfinite_grad_entries=7",
                               capture="/c/capture_step4_nan_grads.json",
                               ts=2.0),
            ttel.AnomalyRecord(kind="nan_grads", step=3, node_id=0, ts=2.0),
            ttel.AnomalyRecord(kind="loss_spike", step=5, node_id=0,
                               value=9.0, ts=2.0),
            ttel.ResourceRecord(node_id=2, ts=2.0),
            ttel.NumericEvent(kind="loss_spike", step=5, value=9.0,
                              detail="3:9.0000", ts=3.0),
            ttel.ElasticEvent(kind="node_down", node_id=1, ts=4.0),
            ttel.ElasticEvent(kind="first_step_back", ts=5.0),
            ttel.HealthSummary(kind="loss_spike", first_step=5, ranks="0",
                               n_ranks=1, world=3,
                               verdict="suspect_data_or_hardware", ts=6.0)):
        sink.emit(rec)
    sink.close()
    with open(path, "a") as f:
        f.write("not a record\n")
        f.write('{"r": "StepRecord", "d": {"st')
    return str(path)


def test_a_port_flight_record_replays_to_the_jax_report(tmp_path, capsys):
    path = _flight(tmp_path)
    mine = thc.diagnose(thc.load_records(path))
    theirs = jhc.diagnose(jhc.load_records(path))
    for key in mine:
        assert mine[key] == theirs[key], key
    assert set(theirs) - set(mine) == {"sparse_serving"}
    assert not any(theirs[k] for k in set(theirs) - set(mine))
    assert thc.format_report(mine) == jhc.format_report(theirs)
    assert mine["world"] == 3 and not mine["healthy"]
    assert mine["anomalies"]["nan_grads"]["verdict"] == "suspect_partial"
    assert thc.main([path, "--world", "2"]) == 1
    assert "verdict: suspect_model_or_config" in capsys.readouterr().out
    assert thc.main([path, "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["elastic_events"] == {
        "first_step_back": 1, "node_down": 1}


def test_a_healthy_record_replays_healthy(tmp_path):
    path = tmp_path / "ok.jsonl"
    sink = ttel.JsonlSink(str(path))
    sink.emit(ttel.StepRecord(step=1, loss=2.0, ts=1.0))
    sink.close()
    diag = thc.diagnose(thc.load_records(str(path)))
    assert diag["healthy"]
    assert thc.format_report(diag) == jhc.format_report(
        jhc.diagnose(jhc.load_records(str(path))))
    assert thc.main([str(path)]) == 0


def _trees():
    rng = np.random.default_rng(5)
    a = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "blocks": [rng.standard_normal(5).astype(np.float32),
                    rng.standard_normal(2).astype(np.float32)],
         "b": rng.standard_normal(6).astype(np.float32)}
    b = {"w": a["w"] + 1e-6,
         "blocks": [a["blocks"][0] * 1.01, np.zeros(3, np.float32)],
         "b": np.where(np.arange(6) == 2, np.inf, a["b"]).astype(np.float32)}
    return a, b


def test_numeric_checker_and_check_finite_equal_jax():
    import torch

    a, b = _trees()
    tb = {"w": torch.from_numpy(b["w"]),
          "blocks": [torch.from_numpy(x) for x in b["blocks"]],
          "b": torch.from_numpy(b["b"])}
    for kw in ({}, {"rtol": 1e-1, "atol": 1e-3}):
        mine, theirs = tnum.NumericChecker(**kw), jnum.NumericChecker(**kw)
        # as JSON text: a NaN error reads "NaN" on both sides
        assert json.dumps(mine.compare(a, tb), sort_keys=True) == \
            json.dumps(theirs.compare(a, b), sort_keys=True)
        assert mine.allclose(a, tb) == theirs.allclose(a, b)
        assert mine.allclose(a, a) and theirs.allclose(a, a)
    assert tnum.check_finite(tb) == jnum.check_finite(b) == ["['b']"]
