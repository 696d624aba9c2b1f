"""The port's job metrics, goodput and telemetry wiring against the JAX
package's (``master/job_metrics.py``, the master's hub and sinks).

Mirrors the goodput, collector and endpoint cases of
``tests/test_master.py`` and ``tests/test_observability.py``:

- the same mark sequence (startup stall, a node failure at a step, a
  stale report from before the failure, a report at the stall's step,
  an advancing one, a hang stall backdated by its window, completion
  and a failure after it) goes to the JAX ``GoodputTracker`` and the
  port's under one fake clock: ``goodput()``, ``lost_seconds()`` and
  ``wall_seconds()`` equal after every mark;
- ``JobMetricCollector``: the same counters, gauges (through each
  package's ``MetricsSink``, from records the two packages share), job
  meta and runtime records give the same ``to_json()`` and the same
  ``prometheus_text()`` lines; the port's ``MetricsHTTPServer`` serves
  both on an ephemeral port;
- the port's master end to end: a node failure stalls the goodput its
  endpoint reports, a step report past the failure's step closes the
  stall, and a stale one does not; ``node_failures_total`` counts the
  failure;
- a worker's ``MasterSink`` (the port's, over the port's client, and the
  JAX one, whose ``TelemetryEventReport`` is JAX-encoded) sends an
  ``AnomalyRecord`` that comes out of the master's hub as the same
  record and reaches its ``HealthAggregator``; the master's JSONL sink
  under ``DLROVER_TPU_TELEMETRY_DIR`` records it.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from dlrover_tpu.common import messages as jmsgs
from dlrover_tpu.master import job_metrics as jjm
from dlrover_tpu.observability import telemetry as jtel
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.master import job_metrics as tjm
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.observability import telemetry as ttel

# (mark, kwargs) at fake times: the master's clock only
MARKS = [
    (1.0, "productive", dict(step=1, report_ts=1.0)),     # closes startup
    (3.0, "stalled", dict(at_step=5)),                    # node failure
    (3.5, "productive", dict(step=6, report_ts=2.9)),     # sent before
    (4.0, "productive", dict(step=5, report_ts=4.0)),     # at the stall
    (9.0, "productive", dict(step=6, report_ts=9.0)),     # advances
    (12.0, "stalled", dict(at_step=8, accounted_from=5.0)),  # hang, clamped
    (14.0, "productive", dict(step=9, report_ts=14.0)),
    (20.0, "stalled", dict(at_step=9, accounted_from=16.0)),  # backdated
    (22.0, "completed", {}),
    (25.0, "stalled", dict(at_step=12)),                  # after the end
]


def _drive(mod):
    t = mod.GoodputTracker(now=0.0)
    readings = [(t.goodput(0.5), t.lost_seconds(0.5), t.wall_seconds(0.5))]
    for now, mark, kw in MARKS:
        getattr(t, f"mark_{mark}")(now=now, **kw)
        for at in (now, now + 0.25):
            readings.append((t.goodput(at), t.lost_seconds(at),
                             t.wall_seconds(at)))
    return readings


def test_goodput_tracker_equals_jax_under_a_fake_clock():
    mine, theirs = _drive(tjm), _drive(jjm)
    assert mine == theirs
    # the stale reports closed nothing; the backdated stalls start at the
    # last close (9) or their window (16): 1 + (9 - 3) + (14 - 9) + (22 - 16)
    assert mine[-1][1] == pytest.approx(1.0 + 6.0 + 5.0 + 6.0)


def _records(mod):
    return [
        mod.StepRecord(step=3, loss=2.5, step_time_s=0.1,
                       tokens_per_s=1000.0, ts=1.0),
        mod.CheckpointRecord(kind="persist", step=4, seconds=1.5,
                             nbytes=10, ts=2.0),
        mod.ElasticEvent(kind="rendezvous", seconds=0.75, ts=3.0),
        mod.ElasticEvent(kind="node_down", node_id=1, ts=3.5),
        mod.AnomalyRecord(kind="nan_grads", step=7, node_id=1, ts=4.0),
        mod.HealthSummary(kind="nan_grads", first_step=7, ranks="1",
                          n_ranks=1, world=2, ts=4.5),
        mod.ResourceRecord(node_id=0, hbm_mb=12.0, hbm_peak_mb=20.0,
                           ts=5.0),
        mod.StragglerRecord(node_id=1, step=3, max_step=9, lag_steps=6,
                            ts=6.0),
        mod.PlanRecord(config="c", suggested_bucket_mb=4.0,
                       planned_exposed_us=12.0, ts=7.0),
        mod.NumericEvent(kind="loss_spike", step=8, value=9.0, ts=8.0),
    ]


def _collector(jm, tel):
    c = jm.JobMetricCollector()
    c.goodput_tracker = jm.GoodputTracker(now=0.0)
    sink = tel.MetricsSink(c)
    for rec in _records(tel):
        sink.emit(rec)
    c.inc("node_failures_total")
    c.set_job_meta(model_name="llama", num_params=7, seq_len=9)
    return c


def test_job_metric_collector_equals_jax(monkeypatch):
    mine, theirs = _collector(tjm, ttel), _collector(jjm, jtel)
    # the goodput reads the clock: one fixed reading for both
    for mod in (tjm, jjm):
        monkeypatch.setattr(mod.time, "monotonic", lambda: 10.0)
        monkeypatch.setattr(mod.time, "time", lambda: 1000.0)
    for c in (mine, theirs):
        c.collect_runtime(12, 0.5, 2, hbm_used_mb_avg=3.0)
    assert json.loads(mine.to_json()) == json.loads(theirs.to_json())
    assert mine.prometheus_text().splitlines() == \
        theirs.prometheus_text().splitlines()
    doc = json.loads(mine.to_json())
    assert doc["counters"]["anomaly_records_total"] == 1
    assert doc["gauges"]["failover_rendezvous_s"] == 0.75
    assert doc["goodput"] == pytest.approx(0.0)  # never productive


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def test_metrics_http_server_serves_prometheus_and_json():
    c = _collector(tjm, ttel)
    srv = tjm.MetricsHTTPServer(c, port=0)
    srv.stop()  # before start: a no-op
    srv.start()
    try:
        assert srv.port > 0
        status, ctype, body = _get(srv.port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert "dlrover_tpu_node_failures_total 1.0" in body.splitlines()
        assert "dlrover_tpu_goodput" in body
        status, ctype, body = _get(srv.port, "/json")
        assert ctype == "application/json"
        assert json.loads(body)["meta"]["model_name"] == "llama"
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.port, "/nope")
    finally:
        srv.stop()


@pytest.fixture
def master():
    m = JobMaster(port=0, num_workers=1)
    m.prepare()
    yield m
    m.stop()


def _endpoint(m):
    return json.loads(_get(m.metrics_server.port, "/json")[2])


def test_the_masters_goodput_drops_at_a_failure_and_recovers(master):
    c = MasterClient(master.addr, node_id=0)
    c.register_node(local_chips=1)
    c.report_node_status("running")
    c.report_global_step(1)
    c.report_global_step(2)
    closed = _endpoint(master)
    assert 0.0 < closed["goodput"] <= 1.0
    # the node fails: lost time grows from here
    c.report_node_status("failed")
    a = _endpoint(master)
    time.sleep(0.3)
    b = _endpoint(master)
    assert b["goodput_lost_seconds"] >= a["goodput_lost_seconds"] + 0.25
    assert b["goodput"] < closed["goodput"]
    assert b["counters"]["node_failures_total"] == 1
    # a report at the failure's step closes nothing, one past it does
    c.report_global_step(2)
    time.sleep(0.1)
    assert _endpoint(master)["goodput_lost_seconds"] > \
        b["goodput_lost_seconds"]
    c.report_global_step(3)
    lost = _endpoint(master)["goodput_lost_seconds"]
    time.sleep(0.2)
    after = _endpoint(master)
    assert after["goodput_lost_seconds"] == lost
    assert after["goodput"] > b["goodput"]
    text = _get(master.metrics_server.port, "/metrics")[2].splitlines()
    assert "dlrover_tpu_node_failures_total 1.0" in text


def _anomaly(mod, **kw):
    return mod.AnomalyRecord(kind="nan_grads", step=4, node_id=1, value=3.0,
                             detail="nonfinite_grad_entries=3",
                             capture="/c/capture_step4_nan_grads.json",
                             ts=12.5, **kw)


def test_a_port_master_sink_reaches_the_masters_hub_and_aggregator(master):
    seen = []
    master.telemetry_hub.subscribe(seen.append)
    client = MasterClient(master.addr, node_id=1)
    sink = ttel.MasterSink(client)
    sink.emit(ttel.StepRecord(step=1))  # per-step records stay off the wire
    sink.emit(_anomaly(ttel))
    got = [r for r in seen if type(r).__name__ == "AnomalyRecord"]
    assert [r.to_json() for r in got] == [_anomaly(ttel).to_json()]
    assert not any(type(r).__name__ == "StepRecord" for r in seen)
    summary = master.health_aggregator.summaries["nan_grads"]
    assert (summary.ranks, summary.verdict) == ("1",
                                                "suspect_model_or_config")
    assert _endpoint(master)["counters"]["anomaly_records_total"] == 1


def test_a_jax_master_sink_report_decodes_in_the_port_master(
        master, tmp_path, monkeypatch):
    seen = []
    master.telemetry_hub.subscribe(seen.append)
    transport = comm.MasterTransportClient(master.addr, retries=1)

    class JaxWire:
        """What the JAX client puts on the wire for report_telemetry."""

        def report_telemetry(self, payload):
            return transport.call(b"r", jmsgs.serialize(
                jmsgs.TelemetryEventReport(node_id=1, payload=payload)))

    jtel.MasterSink(JaxWire()).emit(_anomaly(jtel))
    assert [r.to_json() for r in seen
            if type(r).__name__ == "AnomalyRecord"] == [
        _anomaly(ttel).to_json()]
    # a payload of no known record is refused, not raised
    bad = MasterClient(master.addr, node_id=1)
    assert not bad.report_telemetry('{"r": "NoSuchRecord", "d": {}}')


def test_the_master_records_its_hub_under_the_telemetry_dir(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_TELEMETRY_DIR", str(tmp_path))
    m = JobMaster(port=0, num_workers=2)
    m.prepare()
    try:
        MasterClient(m.addr, node_id=0).report_telemetry(
            _anomaly(ttel).to_json())
    finally:
        m.stop()
    files = list(tmp_path.glob("telemetry-master-*.jsonl"))
    assert len(files) == 1
    lines = files[0].read_text().splitlines()
    kinds = [json.loads(x)["r"] for x in lines]
    # the anomaly, then the aggregator's verdict on it (one rank of two)
    assert kinds == ["AnomalyRecord", "HealthSummary"]
    assert jtel.from_json(lines[1]).verdict == "suspect_data_or_hardware"


def test_the_launchers_local_master_stops_before_the_launcher_returns():
    """The launcher stops its in-process master and waits for the loop:
    the master's stop (its dataset summary, the endpoint closed) runs to
    its end before the launcher's process can exit under it."""
    from dlrover_tpu_torch.agent import launcher

    master, thread = launcher._launch_local_master(1, 1, 1)
    port = master.metrics_server.port
    assert _get(port, "/json")[0] == 200
    launcher._stop_local_master(master, thread, timeout_s=30)
    assert not thread.is_alive()
    with pytest.raises(OSError):
        _get(port, "/json")
