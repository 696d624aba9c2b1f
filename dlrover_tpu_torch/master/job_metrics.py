"""Job metrics collection and export: the goodput tracker, the job
metric collector and its HTTP endpoint.

A copy of ``dlrover_tpu/master/job_metrics.py`` (the module imports no
JAX, but the port imports nothing of the JAX package). Reference:
dlrover/python/master/stats/ (JobMetricCollector job_collector.py:185,
reporter.py, training_metrics.py) and the xpu_timer Prometheus export.
The master marks its ``GoodputTracker`` (``master/master.py``,
``master/servicer.py``), its telemetry hub feeds the collector's gauges
and counters (``observability/telemetry.py`` ``MetricsSink``), and
``MetricsHTTPServer`` serves them as Prometheus text (``/metrics``) and
JSON (``/json``).
"""

import json
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Deque, Dict, Optional


@dataclass
class RuntimeRecord:
    timestamp: float
    global_step: int
    speed_steps_per_s: float
    worker_num: int
    cpu_percent_avg: float = 0.0
    hbm_used_mb_avg: float = 0.0


@dataclass
class JobMeta:
    job_name: str = ""
    model_name: str = ""
    num_params: int = 0
    flops_per_token: float = 0.0
    global_batch_size: int = 0
    seq_len: int = 0
    strategy_json: str = ""


class GoodputTracker:
    """Training goodput = productive wall-time / total wall-time.

    The reference's headline fault-tolerance metric (GLM-65B goodput
    69% → 95%, README.md:57-58; flash-ckpt wasted-time reduction,
    docs/blogs/flash_checkpoint.md:38-41). The master marks the job
    STALLED from startup and from every node failure / hang kick until
    the next global-step report arrives — so rendezvous, restart,
    restore, and recompilation spans all land in lost time.

    Interval arithmetic defaults to ``time.monotonic()`` so an NTP
    step on the master can never inflate (or un-count) lost time.  The
    one wall-clock comparison — ``report_ts`` (a WORKER's wall clock)
    vs the stall detection time — keeps a separate wall-clock guard,
    because cross-host ordering is only expressible in wall time.
    Tests inject coherent ``now`` floats for both clocks.
    """

    def __init__(self, now: Optional[float] = None):
        self._lock = threading.Lock()
        self._start = now if now is not None else time.monotonic()
        self._stalled_since: Optional[float] = self._start
        self._stall_guard_ts: float = (
            now if now is not None else time.time()
        )
        self._stall_step: Optional[int] = None
        self._last_close: float = self._start
        self._lost = 0.0
        self._completed = False

    def mark_stalled(
        self,
        now: Optional[float] = None,
        at_step: Optional[int] = None,
        accounted_from: Optional[float] = None,
    ):
        """``at_step``: the global step when the stall began — a later
        step report only closes the stall once training ADVANCES past it
        (an in-flight report from a surviving worker, processed moments
        after a node died, must not mark the whole recovery productive).

        ``accounted_from``: backdated start for LOST-TIME accounting
        (hang detection learns of a stall only after its idle window) —
        clamped to the last stall close so no second is charged twice.
        The report-timestamp guard still uses ``now`` (detection time):
        reports taken inside the idle window prove nothing either way,
        but their steps cannot advance past ``at_step`` while hung.
        """
        with self._lock:
            if self._completed:
                return  # training finished — see mark_completed
            if self._stalled_since is None:
                ts = now if now is not None else time.monotonic()
                acct = accounted_from if accounted_from is not None else ts
                self._stalled_since = max(acct, self._last_close)
                # wall-clock guard for worker-reported timestamps; a
                # single injected ``now`` serves both clocks in tests
                self._stall_guard_ts = (
                    now if now is not None else time.time()
                )
                self._stall_step = at_step

    def mark_productive(
        self,
        now: Optional[float] = None,
        step: Optional[int] = None,
        report_ts: Optional[float] = None,
    ):
        """``report_ts``: when the step was actually taken (worker-side
        timestamp). A report generated BEFORE the stall opened is
        in-flight state from the pre-failure world — it proves nothing
        about recovery, whatever its step number (a surviving rank can
        race the failure with a step above the master's last-seen one).
        Clock skew between hosts shifts this boundary by the skew; the
        step guard below is the skew-free backstop."""
        with self._lock:
            if self._stalled_since is None:
                return
            if report_ts is not None and report_ts <= self._stall_guard_ts:
                return  # sent before the stall was detected — in-flight
            if (
                step is not None
                and self._stall_step is not None
                and step <= self._stall_step
            ):
                return  # stale report from before/at the stall point
            ts = now if now is not None else time.monotonic()
            self._lost += max(0.0, ts - self._stalled_since)
            self._stalled_since = None
            self._stall_step = None
            self._last_close = ts

    def mark_completed(self, now: Optional[float] = None):
        """A worker ran to its final training step: the job's training
        objective is reached, so there is no productive time left to
        lose. Any open stall closes here (charged up to completion) and
        later ``mark_stalled`` calls become no-ops — otherwise a failure
        *detected* after the job finished (a heartbeat timeout racing
        teardown: the dead node's stall can never be closed by a step
        report, since no step will ever advance past the final one)
        would accrue lost time forever."""
        with self._lock:
            if self._stalled_since is not None:
                ts = now if now is not None else time.monotonic()
                self._lost += max(0.0, ts - self._stalled_since)
                self._stalled_since = None
                self._stall_step = None
                self._last_close = ts
            self._completed = True

    def lost_seconds(self, now: Optional[float] = None) -> float:
        with self._lock:
            ts = now if now is not None else time.monotonic()
            lost = self._lost
            if self._stalled_since is not None:
                lost += max(0.0, ts - self._stalled_since)
            return lost

    def goodput(self, now: Optional[float] = None) -> float:
        ts = now if now is not None else time.monotonic()
        wall = ts - self._start
        if wall <= 0:
            return 1.0
        return max(0.0, 1.0 - self.lost_seconds(ts) / wall)

    def wall_seconds(self, now: Optional[float] = None) -> float:
        ts = now if now is not None else time.monotonic()
        return max(0.0, ts - self._start)


class JobMetricCollector:
    def __init__(self, max_records: int = 4096):
        self._lock = threading.Lock()
        self.meta = JobMeta()
        self.goodput_tracker: Optional[GoodputTracker] = None
        self.records: Deque[RuntimeRecord] = deque(maxlen=max_records)
        self.counters: Dict[str, float] = {
            "node_failures_total": 0,
            "worker_restarts_total": 0,
            "rdzv_rounds_total": 0,
            "ckpt_commits_total": 0,
        }
        # free-form gauges set by the telemetry bus (MetricsSink): plan
        # numbers, overlap drift, failover phase seconds, HBM watermark
        self.gauges: Dict[str, float] = {}

    def set_job_meta(self, **kw):
        with self._lock:
            for k, v in kw.items():
                if hasattr(self.meta, k):
                    setattr(self.meta, k, v)

    def collect_runtime(
        self,
        global_step: int,
        speed: float,
        worker_num: int,
        cpu_percent_avg: float = 0.0,
        hbm_used_mb_avg: float = 0.0,
    ):
        with self._lock:
            self.records.append(
                RuntimeRecord(
                    timestamp=time.time(),
                    global_step=global_step,
                    speed_steps_per_s=speed,
                    worker_num=worker_num,
                    cpu_percent_avg=cpu_percent_avg,
                    hbm_used_mb_avg=hbm_used_mb_avg,
                )
            )

    def inc(self, counter: str, delta: float = 1.0):
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0) + delta

    def set_gauge(self, name: str, value: float):
        with self._lock:
            self.gauges[name] = float(value)

    # ---- export ----------------------------------------------------------

    def _goodput(self) -> Optional[float]:
        if self.goodput_tracker is None:
            return None
        return self.goodput_tracker.goodput()

    def to_json(self) -> str:
        gp = self._goodput()
        # raw lost/wall terms let a consumer compute goodput over a
        # WINDOW (two samples), not just since master start — the fault
        # drill regression-gates windowed goodput this way
        tracker = self.goodput_tracker
        lost = tracker.lost_seconds() if tracker else None
        wall = tracker.wall_seconds() if tracker else None
        with self._lock:
            return json.dumps(
                {
                    "meta": asdict(self.meta),
                    "counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "goodput": gp,
                    "goodput_lost_seconds": lost,
                    "goodput_wall_seconds": wall,
                    "records": [asdict(r) for r in list(self.records)[-100:]],
                }
            )

    def prometheus_text(self) -> str:
        """Prometheus exposition format (xpu_timer-style export surface)."""
        gp = self._goodput()
        with self._lock:
            lines = []
            for name, value in self.counters.items():
                lines.append(f"# TYPE dlrover_tpu_{name} counter")
                lines.append(f"dlrover_tpu_{name} {value}")
            for name, value in sorted(self.gauges.items()):
                lines.append(f"# TYPE dlrover_tpu_{name} gauge")
                lines.append(f"dlrover_tpu_{name} {value}")
            if gp is not None:
                lines.append("# TYPE dlrover_tpu_goodput gauge")
                lines.append(f"dlrover_tpu_goodput {gp}")
            if self.records:
                last = self.records[-1]
                gauges = {
                    "global_step": last.global_step,
                    "speed_steps_per_second": last.speed_steps_per_s,
                    "worker_num": last.worker_num,
                    "hbm_used_mb_avg": last.hbm_used_mb_avg,
                }
                for name, value in gauges.items():
                    lines.append(f"# TYPE dlrover_tpu_{name} gauge")
                    lines.append(f"dlrover_tpu_{name} {value}")
            return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """Tiny /metrics + /json endpoint (Prometheus scrape target).

    The socket binds in ``start()`` (not __init__) so constructing a master
    that never runs doesn't hold a port, and ``stop()`` before ``start()``
    is a safe no-op.
    """

    def __init__(self, collector: JobMetricCollector, port: int = 0):
        self._collector = collector
        self._requested_port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self.port = 0

    def start(self):
        import http.server

        collector_ref = self._collector

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/metrics"):
                    body = collector_ref.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/json"):
                    body = collector_ref.to_json().encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence request logging
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("", self._requested_port), Handler
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http", daemon=True
        )
        self._thread.start()

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
