"""Host-side anomaly watchdog: sentinel streams → classified
AnomalyRecords → rate-limited triggered captures → cross-host
HealthSummary.

A copy of the training half of ``dlrover_tpu/observability/watchdog.py``
(the module imports no JAX; the port imports nothing of the JAX
package). Reference pattern: xpu_timer's hang/NaN diagnosis loop —
cheap always-on signals classified on the host, with the expensive
evidence (a profiled step's kernel breakdown) captured only when
something trips, under a hard budget so an anomaly storm cannot turn the
run into a profiling session.

* ``Watchdog`` (worker-side): consumes each step's host metrics (the
  sentinel scalars of ``observability/sentinels.py``, read with the
  step's loss), its own loss-spike z-score detector and the measured
  against the planned step time; classifies into ``nan_grads``,
  ``loss_spike``, ``fp8_saturation``, ``step_time_regression`` and
  ``straggler`` AnomalyRecords on the hub. When an anomaly fires and the
  capture budget allows, it reserves a deterministic capture path (named
  in the record at once, so the record → artifact link survives a crash
  before the capture lands) and the trainer force-samples its runtime
  timer on the next step; ``write_capture`` then persists the runtime
  breakdown.
* ``verdict_for`` / ``HealthAggregator`` (master-side): correlate the
  per-worker AnomalyRecords arriving over the wire — one rank reporting
  NaNs points at that host's data shard or hardware, every rank at the
  model or config — into ``HealthSummary`` records.
* The offline replay is ``observability/healthcheck.py``.

* ``ServingWatchdog`` (a serving replica): classifies the published
  ``ServingRecord`` stream and the router's migration reports into SLO
  anomalies (``SERVING_ANOMALY_KINDS``) with a frozen engine snapshot
  as the capture; its gate edges feed the serving autoscaler.

The JAX capture also holds the breakdown's collective time against the
compile-time overlap plan (``plan_diff``), which waits for the strategy
engine (ROADMAP A20).
"""

import json
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.loss_spike import LossSpikeDetector

logger = get_logger(__name__)

ANOMALY_KINDS = (
    "nan_grads",
    "loss_spike",
    "fp8_saturation",
    "step_time_regression",
    "straggler",
)

#: serving-tier SLO anomaly kinds (``ServingWatchdog``): the same
#: AnomalyRecord envelope, correlated by ``replica`` instead of step
SERVING_ANOMALY_KINDS = (
    "slo_breach",
    "ttft_regression",
    "spec_accept_collapse",
    "shed_storm",
    "migration_fallback",
)


@dataclass
class WatchdogConfig:
    """Thresholds + capture policy for one worker's watchdog."""

    node_id: int = -1
    # where triggered-capture artifacts land ("" = classification only,
    # no captures — e.g. when no runtime timer is available)
    capture_dir: str = ""
    # fraction of fp8 amax histories saturating in one step before the
    # delayed-scaling state is declared stale
    fp8_sat_threshold: float = 0.5
    # measured step time beyond factor × the plan's planned_step_time_s
    # ⇒ step_time_regression
    step_time_factor: float = 1.5
    # skip the first steps of a run before judging step time
    min_step_for_drift: int = 3
    # capture rate limit + lifetime budget (storm protection)
    min_capture_interval_s: float = 60.0
    max_captures: int = 5
    # loss-spike gate (LossSpikeDetector defaults are production-sized;
    # the watchdog re-exposes them so drills can warm up fast)
    spike_min_iter: int = 100
    spike_min_loss: float = 4.0
    spike_zscore: Optional[float] = 4.0
    spike_window: int = 200


class Watchdog:
    """Classify one worker's per-step health stream into anomalies.

    Feed it from the training loop: ``observe(step, host_metrics, ...)``
    after each step's metrics land on the host (per-step loop) or once
    per drained step (block loop). Publishing goes through the process
    telemetry hub; a disabled hub still accumulates ``self.anomalies``.
    """

    def __init__(self, config: Optional[WatchdogConfig] = None,
                 clock=time.monotonic):
        self.cfg = config or WatchdogConfig()
        self._clock = clock
        self._spike = LossSpikeDetector(
            save_dir=None,
            min_iter=self.cfg.spike_min_iter,
            min_loss=self.cfg.spike_min_loss,
            zscore=self.cfg.spike_zscore,
            window=self.cfg.spike_window,
            publish_events=False,  # the trainer's detector owns the event
        )
        self.anomalies: List[telemetry.AnomalyRecord] = []
        self._captures_used = 0
        self._last_capture_t: Optional[float] = None
        self._pending_capture = ""
        self._pending_kind = ""
        self._pending_step = -1

    # ---- classification --------------------------------------------------

    def observe(self, step: int, metrics: Dict[str, float],
                step_time_s: float = 0.0,
                planned_step_time_s: float = 0.0
                ) -> List[telemetry.AnomalyRecord]:
        """Classify one step. ``metrics`` are host floats (the step's
        metrics; the sentinel keys optional). Returns the AnomalyRecords
        published for this step."""

        def val(key: str) -> float:
            v = metrics.get(key)
            return float(v) if v is not None else 0.0

        out: List[telemetry.AnomalyRecord] = []
        nonfinite = val("sent_nonfinite")
        loss_nonfinite = val("sent_loss_nonfinite")
        if nonfinite > 0 or loss_nonfinite > 0:
            out.append(self._anomaly(
                "nan_grads", step, value=nonfinite,
                detail=(f"nonfinite_grad_entries={nonfinite:g} "
                        f"loss_nonfinite={loss_nonfinite:g} "
                        f"sanitizer_skips={val('sent_sanitizer_skips'):g}")))
        if "loss" in metrics and self._spike.update(
                step, float(metrics["loss"])):
            out.append(self._anomaly("loss_spike", step,
                                     value=float(metrics["loss"])))
        fp8_sat = val("sent_fp8_sat")
        if fp8_sat > self.cfg.fp8_sat_threshold:
            out.append(self._anomaly(
                "fp8_saturation", step, value=fp8_sat,
                detail=f"threshold={self.cfg.fp8_sat_threshold:g}"))
        if (planned_step_time_s > 0
                and step >= self.cfg.min_step_for_drift
                and step_time_s
                > self.cfg.step_time_factor * planned_step_time_s):
            out.append(self._anomaly(
                "step_time_regression", step, value=step_time_s,
                detail=(f"planned={planned_step_time_s:.6f}s "
                        f"factor={self.cfg.step_time_factor:g}")))
        return out

    def observe_straggler(self, step: int, lag_steps: int,
                          ratio: float) -> telemetry.AnomalyRecord:
        """Explicit straggler classification (the master's speed-monitor
        verdict relayed to this worker, or a worker's own lag)."""
        return self._anomaly("straggler", step, value=float(ratio),
                             detail=f"lag_steps={lag_steps}")

    def _anomaly(self, kind: str, step: int, value: float = 0.0,
                 detail: str = "") -> telemetry.AnomalyRecord:
        capture = self._reserve_capture(kind, step)
        rec = telemetry.AnomalyRecord(
            kind=kind, step=step, node_id=self.cfg.node_id,
            value=float(value), detail=detail, capture=capture)
        self.anomalies.append(rec)
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(rec)
        return rec

    # ---- triggered capture ----------------------------------------------

    @property
    def capture_pending(self) -> str:
        """Reserved capture path awaiting a runtime breakdown ("" when
        none). The trainer force-samples its runtime timer while this is
        set, then calls ``write_capture``."""
        return self._pending_capture

    def _reserve_capture(self, kind: str, step: int) -> str:
        if not self.cfg.capture_dir:
            return ""
        if self._pending_capture:
            return ""  # one capture in flight at a time
        if self._captures_used >= self.cfg.max_captures:
            return ""
        now = self._clock()
        if (self._last_capture_t is not None
                and now - self._last_capture_t
                < self.cfg.min_capture_interval_s):
            return ""
        self._captures_used += 1
        self._last_capture_t = now
        self._pending_capture = os.path.join(
            self.cfg.capture_dir, f"capture_step{step}_{kind}.json")
        self._pending_kind = kind
        self._pending_step = step
        return self._pending_capture

    def write_capture(self, step: int, breakdown: List, block: int = 1,
                      plan: Optional[Dict] = None) -> str:
        """Persist the reserved capture: the sampled runtime breakdown
        (``runtime_timer.OpTime`` rows) and the anomaly that triggered
        it. ``block`` labels a K-step capture. Returns the written path
        ("" when nothing was pending)."""
        if not self._pending_capture:
            return ""
        path = self._pending_capture
        doc = {
            "anomaly": {"kind": self._pending_kind,
                        "step": self._pending_step,
                        "node_id": self.cfg.node_id},
            "captured_step": step,
            "block": int(block),
            "ops": [{"op": o.name, "us": o.total_us, "count": o.count,
                     "share": o.fraction} for o in breakdown],
            "plan": plan or {},
        }
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
        logger.info("watchdog capture for %s@%d written to %s",
                    self._pending_kind, self._pending_step, path)
        self._pending_capture = ""
        self._pending_kind = ""
        self._pending_step = -1
        return path


# ---------------------------------------------------------------------------
# serving-tier SLO watchdog
# ---------------------------------------------------------------------------


@dataclass
class ServingWatchdogConfig:
    """Thresholds + capture policy for one serving replica's watchdog.

    A target of 0 disables that gate, so a watchdog can run with only
    the gates its deployment defines SLOs for."""

    node_id: int = -1
    capture_dir: str = ""
    # p99 end-to-end latency SLO (ms); breach fires ``slo_breach``
    p99_target_ms: float = 0.0
    # p99 time-to-first-token target (ms); breach fires ``ttft_regression``
    ttft_target_ms: float = 0.0
    # judging percentiles on a handful of requests is noise
    min_completed: int = 8
    # speculative accept rate below the floor (with enough drafts to
    # judge) fires ``spec_accept_collapse``
    min_accept_rate: float = 0.2
    min_draft_tokens: int = 64
    # ≥ this many NEW drops (shed+rejected+timed_out+poisoned) between
    # two consecutive records fires ``shed_storm``
    shed_storm_drops: int = 8
    # this many CONSECUTIVE non-live migration outcomes fires
    # ``migration_fallback``
    fallback_storm: int = 2
    # capture rate limit + lifetime budget (same storm protection as
    # the training watchdog)
    min_capture_interval_s: float = 60.0
    max_captures: int = 5


class ServingWatchdog:
    """Classify a serving replica's ``ServingRecord`` stream into SLO
    anomalies, with a frozen engine snapshot as the capture artifact.

    Feed it from the server's publish loop: ``observe(record)`` per
    published ServingRecord, ``observe_migration(report)`` per
    router-driven failover. Gates are EDGE-TRIGGERED: an anomaly fires
    on the transition into breach and re-arms only after the gate
    clears, so a sustained breach is one record, not one per publish
    tick.

    Unlike the training watchdog's two-phase capture (reserve → next
    step force-profiled), a serving capture is written IMMEDIATELY:
    ``snapshot_fn`` (usually ``ServingEngine.observability_snapshot``)
    is cheap host state — the phase split, scheduler depth + drop
    counters, and PageAllocator occupancy that tell 'engine got slow'
    from 'queue backed up' from 'out of pages'.
    """

    def __init__(
        self,
        config: Optional[ServingWatchdogConfig] = None,
        clock=time.monotonic,
        snapshot_fn=None,
    ):
        self.cfg = config or ServingWatchdogConfig()
        self._clock = clock
        self.snapshot_fn = snapshot_fn
        self.anomalies: List[telemetry.AnomalyRecord] = []
        self._captures_used = 0
        self._last_capture_t: Optional[float] = None
        self._breached: Dict[str, bool] = {}
        self._last_drops: Optional[int] = None
        self._fallback_streak = 0
        self._n_obs = 0
        # gate-edge subscribers (``subscribe``); the empty-list fast
        # path keeps ``_edge`` allocation-free when nobody listens
        self._subscribers: List = []

    # ---- gate-edge subscription ------------------------------------------

    def subscribe(self, fn) -> None:
        """Deliver every gate EDGE to ``fn(kind, breaching, record)`` —
        both the transition INTO breach (``breaching=True``) and the
        clear (``breaching=False``), with the ServingRecord that flipped
        the gate (None for migration-path gates). This is how the
        serving autoscaler closes the watchdog → ScalePlan loop without
        polling capture artifacts; with no subscribers the hook costs
        one truthiness check per gate evaluation. A subscriber raising
        is logged and never breaks classification."""
        self._subscribers.append(fn)

    def _notify(self, kind: str, breaching: bool, rec) -> None:
        for fn in self._subscribers:
            try:
                fn(kind, breaching, rec)
            except Exception:  # noqa: BLE001 — observers never break gates
                logger.exception(
                    "watchdog gate subscriber failed on %s edge", kind
                )

    # ---- classification --------------------------------------------------

    def observe(self, rec) -> List[telemetry.AnomalyRecord]:
        """Classify one published ServingRecord; returns the
        AnomalyRecords fired by this observation."""
        self._n_obs += 1
        out: List[telemetry.AnomalyRecord] = []
        enough = rec.completed >= self.cfg.min_completed
        if self.cfg.p99_target_ms > 0:
            self._edge(
                out, "slo_breach",
                enough and rec.p99_ms > self.cfg.p99_target_ms,
                rec, value=rec.p99_ms,
                detail=(
                    f"p99={rec.p99_ms:g}ms target="
                    f"{self.cfg.p99_target_ms:g}ms n={rec.completed}"
                ),
            )
        if self.cfg.ttft_target_ms > 0:
            self._edge(
                out, "ttft_regression",
                enough and rec.ttft_p99_ms > self.cfg.ttft_target_ms,
                rec, value=rec.ttft_p99_ms,
                detail=(
                    f"ttft_p99={rec.ttft_p99_ms:g}ms target="
                    f"{self.cfg.ttft_target_ms:g}ms"
                ),
            )
        self._edge(
            out, "spec_accept_collapse",
            (
                rec.draft_tokens >= self.cfg.min_draft_tokens
                and rec.spec_accept_rate < self.cfg.min_accept_rate
            ),
            rec, value=rec.spec_accept_rate,
            detail=(
                f"accept_rate={rec.spec_accept_rate:g} floor="
                f"{self.cfg.min_accept_rate:g} "
                f"drafts={rec.draft_tokens}"
            ),
        )
        drops = rec.shed + rec.rejected + rec.timed_out + rec.poisoned
        delta = drops - (
            self._last_drops if self._last_drops is not None else drops
        )
        self._last_drops = drops
        self._edge(
            out, "shed_storm", delta >= self.cfg.shed_storm_drops,
            rec, value=float(delta),
            detail=(
                f"new_drops={delta} shed={rec.shed} "
                f"rejected={rec.rejected} timed_out={rec.timed_out} "
                f"poisoned={rec.poisoned}"
            ),
        )
        return out

    def observe_migration(
        self, report, replica: str = ""
    ) -> Optional[telemetry.AnomalyRecord]:
        """Track migration outcomes (``MigrationReport.path``): a run
        of non-live outcomes means the live path keeps degrading to
        re-prefill — a page-pressure or geometry problem worth a
        capture."""
        if getattr(report, "path", "live") == "live":
            self._fallback_streak = 0
            if self._breached.get("migration_fallback"):
                self._breached["migration_fallback"] = False
                if self._subscribers:
                    self._notify("migration_fallback", False, None)
            return None
        self._fallback_streak += 1
        out: List[telemetry.AnomalyRecord] = []
        self._edge(
            out, "migration_fallback",
            self._fallback_streak >= self.cfg.fallback_storm,
            None, replica=replica, value=float(self._fallback_streak),
            detail=(
                f"consecutive_fallbacks={self._fallback_streak} "
                f"re_prefilled={len(getattr(report, 're_prefilled', {}))}"
            ),
        )
        return out[0] if out else None

    # ---- internals -------------------------------------------------------

    def _edge(
        self, out, kind: str, breaching: bool, rec,
        value: float = 0.0, detail: str = "", replica: str = "",
    ) -> None:
        was = self._breached.get(kind, False)
        self._breached[kind] = breaching
        if breaching == was:
            return
        if self._subscribers:
            self._notify(kind, breaching, rec)
        if not breaching:
            return
        out.append(self._anomaly(kind, rec, value=value, detail=detail,
                                 replica=replica))

    def _anomaly(
        self, kind: str, rec, value: float = 0.0, detail: str = "",
        replica: str = "",
    ) -> telemetry.AnomalyRecord:
        replica = replica or (rec.replica if rec is not None else "")
        capture = self._reserve_capture(kind, replica)
        anomaly = telemetry.AnomalyRecord(
            kind=kind,
            step=self._n_obs,
            node_id=self.cfg.node_id,
            value=float(value),
            detail=detail,
            capture=capture,
            replica=replica,
        )
        self.anomalies.append(anomaly)
        if capture:
            self._write_capture(capture, anomaly, rec)
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(anomaly)
        return anomaly

    def _reserve_capture(self, kind: str, replica: str) -> str:
        if not self.cfg.capture_dir:
            return ""
        if self._captures_used >= self.cfg.max_captures:
            return ""
        now = self._clock()
        if (
            self._last_capture_t is not None
            and now - self._last_capture_t
            < self.cfg.min_capture_interval_s
        ):
            return ""
        self._captures_used += 1
        self._last_capture_t = now
        tag = (replica or "replica").replace("/", "_")
        return os.path.join(
            self.cfg.capture_dir,
            f"capture_serving{self._n_obs}_{tag}_{kind}.json",
        )

    def _write_capture(self, path: str, anomaly, rec) -> None:
        doc = {
            "anomaly": {
                "kind": anomaly.kind,
                "step": anomaly.step,
                "node_id": anomaly.node_id,
                "replica": anomaly.replica,
                "value": anomaly.value,
                "detail": anomaly.detail,
            },
            "record": asdict(rec) if rec is not None else {},
            "engine": {},
        }
        if self.snapshot_fn is not None:
            try:
                doc["engine"] = self.snapshot_fn()
            except Exception as e:  # noqa: BLE001 — capture must not kill
                doc["engine"] = {"error": str(e)}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2)
            logger.info(
                "serving watchdog capture for %s on %s written to %s",
                anomaly.kind, anomaly.replica, path,
            )
        except OSError as e:
            logger.warning("serving capture write failed: %s", e)


# ---------------------------------------------------------------------------
# master-side cross-host correlation
# ---------------------------------------------------------------------------


def verdict_for(n_ranks: int, world: int) -> str:
    """The one-rank-vs-all-ranks attribution rule: every rank reporting
    means the cause travels with the replicated program (model or
    config); exactly one rank means something local to that host (its
    data shard or its hardware)."""
    if world > 0 and n_ranks >= world:
        return "suspect_model_or_config"
    if n_ranks == 1:
        return "suspect_data_or_hardware"
    return "suspect_partial"


class HealthAggregator:
    """Correlate per-worker AnomalyRecords into HealthSummary records.

    Attach to the MASTER's hub: worker AnomalyRecords arrive via the
    MasterSink → report_telemetry wire and are rehydrated onto the
    master's hub; StragglerRecords from the speed monitor fold in as
    ``straggler`` anomalies. Each time a kind's affected-rank set grows,
    a refreshed HealthSummary is published (and kept in
    ``self.summaries`` for the healthcheck replay)."""

    SUBSCRIBED = ("AnomalyRecord", "StragglerRecord")

    def __init__(self, hub=None, world: int = 0):
        self.world = int(world)
        self._lock = threading.Lock()
        # kind → node_id → first anomalous step seen for that rank
        self._by_kind: Dict[str, Dict[int, int]] = {}
        self.summaries: Dict[str, telemetry.HealthSummary] = {}
        self._hub = None
        if hub is not None:
            self.attach(hub)

    def attach(self, hub) -> None:
        self._hub = hub
        hub.subscribe(self._on_record, types=self.SUBSCRIBED)

    def _on_record(self, record) -> None:
        if type(record).__name__ == "StragglerRecord":
            kind, node_id, step = "straggler", record.node_id, record.step
        else:
            kind, node_id, step = record.kind, record.node_id, record.step
        with self._lock:
            nodes = self._by_kind.setdefault(kind, {})
            new_rank = node_id not in nodes
            if new_rank or step < nodes[node_id]:
                nodes[node_id] = step
            if not new_rank:
                return
            summary = self._summarize(kind)
        if self._hub is not None and getattr(self._hub, "enabled", False):
            self._hub.publish(summary)

    def _summarize(self, kind: str) -> telemetry.HealthSummary:
        nodes = self._by_kind[kind]
        summary = telemetry.HealthSummary(
            kind=kind,
            first_step=min(nodes.values()),
            ranks=",".join(str(n) for n in sorted(nodes)),
            n_ranks=len(nodes),
            world=self.world,
            verdict=verdict_for(len(nodes), self.world),
            detail="first bad step per rank: " + " ".join(
                f"{n}:{s}" for n, s in sorted(nodes.items())),
        )
        self.summaries[kind] = summary
        return summary
