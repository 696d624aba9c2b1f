"""Telemetry records, the sinks that consume them and the hub that fans
them out.

Copies of the JAX package's records (``dlrover_tpu/observability/
telemetry.py``) with the same fields and the same ``to_json`` envelope,
so a record the port publishes reads back through the JAX package's
``from_json`` and the other way round: the trainer's ``StepRecord`` and
``KernelSample`` (the sampled runtime profile), the checkpoint engine's
``CheckpointRecord``, ``ElasticEvent``, the loss-spike detector's
``NumericEvent``, ``CollectiveRecord``, ``PlanRecord`` (the watchdog's
step-time baseline), the watchdog's ``AnomalyRecord`` and the master's
``HealthSummary`` (``observability/watchdog.py``), the serving
replica's ``ServingRecord``, the serving autoscaler's
``ScaleDecisionRecord``, the master speed monitor's
``StragglerRecord``, the agent monitor's ``ResourceRecord``, the
overlap-drift signal the Brain tuner consumes (``OverlapDriftRecord``)
and, registered when ``cluster/brain.py`` is imported, the Brain's
``TuningPlan`` and ``JobMetrics``.

The sinks are the JAX ones: ``JsonlSink`` (one line a record, line
buffered, the flight recorder ``observability/healthcheck.py``
replays), ``MetricsSink`` (gauges and counters onto a collector:
``master/job_metrics.py``'s on the master), ``MasterSink`` (selected
records to the master over ``MasterClient.report_telemetry``) and
``CallbackSink``. The hub keeps the JAX contract: ``get_hub()`` is a
no-op hub whose ``enabled`` is False until ``configure_hub`` installs
one (or ``DLROVER_TPU_TELEMETRY_DIR`` names a directory for a JSONL
file a process), so producers guard with ``if hub.enabled:`` and a
disabled hub costs one attribute read; a sink that raises is detached,
never propagated to the producer. The overlap-drift record's producer
(the measured against the planned exposed collective time) waits for
the strategy engine (ROADMAP A20).
"""

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

_RECORD_TYPES: Dict[str, type] = {}


def _to_json(self) -> str:
    return json.dumps(
        {"r": type(self).__name__, "d": dataclasses.asdict(self)},
        sort_keys=True,
    )


def telemetry_record(cls):
    """Class decorator: dataclass + registry entry + ``to_json``."""
    cls = dataclasses.dataclass(cls)
    cls.to_json = _to_json
    _RECORD_TYPES[cls.__name__] = cls
    return cls


def from_json(line: str):
    """Rehydrate any registered record from its ``to_json`` line."""
    obj = json.loads(line)
    return _RECORD_TYPES[obj["r"]](**obj["d"])


def record_types() -> Dict[str, type]:
    """Registered name → class map."""
    return dict(_RECORD_TYPES)


@telemetry_record
class StepRecord:
    """One optimizer step as seen by the trainer."""

    step: int = 0
    loss: float = 0.0
    step_time_s: float = 0.0
    tokens_per_s: float = 0.0
    accum: int = 1
    ts: float = 0.0


@telemetry_record
class CollectiveRecord:
    """One collective class's wire traffic (planned or measured)."""

    op: str = ""
    bytes: int = 0
    wire_dtype: str = ""
    wire_us: float = 0.0
    exposed_us: float = 0.0
    ts: float = 0.0


@telemetry_record
class CheckpointRecord:
    """One save/restore action at any tier of the checkpoint stack."""

    kind: str = ""  # save_memory | persist | persist_wait | restore
    step: int = -1
    seconds: float = 0.0
    nbytes: int = 0
    ok: bool = True
    tier: str = ""  # memory | replica | storage
    ts: float = 0.0


@telemetry_record
class KernelSample:
    """One op from a sampled runtime-profiler step breakdown
    (``observability/runtime_timer.py``). ``block`` is the number of
    train steps the trace covered: 1 for the per-step loop, K when the
    profiled dispatch was a K-step block (the µs then span the block)."""

    step: int = -1
    op: str = ""
    us: float = 0.0
    share: float = 0.0
    block: int = 1
    ts: float = 0.0


@telemetry_record
class PlanRecord:
    """Planning numbers surfaced at run time, so tuners can compare the
    plan with what ran; ``planned_step_time_s`` is the watchdog's
    baseline for ``step_time_regression`` (0: none)."""

    config: str = ""
    suggested_bucket_mb: float = 0.0
    planned_exposed_us: float = 0.0
    planned_hidden_us: float = 0.0
    assumed_ici_gbps: float = 0.0
    update_sharding_reason: str = ""
    planned_step_time_s: float = 0.0
    ts: float = 0.0


@telemetry_record
class ElasticEvent:
    """A failover / membership phase transition."""

    kind: str = ""  # first_step_back | ...
    node_id: int = -1
    rdzv_round: int = -1
    restart: int = -1
    seconds: float = 0.0
    detail: str = ""
    ts: float = 0.0


@telemetry_record
class OverlapDriftRecord:
    """Planned exposed-collective µs against measured: the signal the
    Brain tuner's drift ladder consumes (``cluster/brain.py``)."""

    step: int = -1
    planned_exposed_us: float = 0.0
    measured_collective_us: float = 0.0
    drift_us: float = 0.0
    drift_frac: float = 0.0
    ts: float = 0.0


@telemetry_record
class StragglerRecord:
    """A worker lagging the per-worker step watermark front (the
    master's speed monitor publishes it)."""

    node_id: int = -1
    step: int = 0
    max_step: int = 0
    lag_steps: int = 0
    ratio: float = 0.0
    ts: float = 0.0


@telemetry_record
class ResourceRecord:
    """A node's host and device memory use as its agent's monitor reports
    it (``hbm_*``: the JAX field names; on the card, its memory)."""

    node_id: int = -1
    cpu_percent: float = 0.0
    mem_mb: float = 0.0
    hbm_mb: float = 0.0
    hbm_peak_mb: float = 0.0
    ts: float = 0.0


@telemetry_record
class NumericEvent:
    """A numeric-health incident (loss spike, ...)."""

    kind: str = ""
    step: int = -1
    value: float = 0.0
    detail: str = ""
    ts: float = 0.0


@telemetry_record
class AnomalyRecord:
    """One classified training anomaly from the host-side watchdog.

    ``kind`` is one of ``observability.watchdog.ANOMALY_KINDS``
    (nan_grads | loss_spike | fp8_saturation | step_time_regression |
    straggler). ``capture`` is the path of the triggered-capture
    artifact when the rate limiter granted one, else "". ``replica``
    names a serving replica for the serving kinds ("" for training)."""

    kind: str = ""
    step: int = -1
    node_id: int = -1
    value: float = 0.0
    detail: str = ""
    capture: str = ""
    replica: str = ""
    ts: float = 0.0


@telemetry_record
class HealthSummary:
    """Master-side cross-host correlation of worker AnomalyRecords.

    ``verdict`` encodes the attribution rule: one rank reporting →
    suspect data/hardware on that host; every rank reporting → suspect
    model/config. ``ranks`` is a comma-joined sorted rank list."""

    kind: str = ""
    first_step: int = -1
    ranks: str = ""
    n_ranks: int = 0
    world: int = 0
    verdict: str = ""
    detail: str = ""
    ts: float = 0.0


@telemetry_record
class ServingRecord:
    """Periodic serving-replica snapshot (serving/scheduler.py publish).

    Latencies are end-to-end request milliseconds (submit → complete);
    ``tokens_per_s`` is the engine's decode throughput since its first
    step. ``ttft_*`` is time-to-first-token, ``tpot_*`` time per output
    token, ``queue_wait_p99_ms`` enqueue → engine admission, and
    ``hists`` the JSON-encoded per-phase histogram envelope. The
    speculative, migration, prefix and disaggregation fields stay at
    their defaults in the port until those features are ported."""

    replica: str = ""
    active_slots: int = 0
    queue_depth: int = 0
    admitted: int = 0
    completed: int = 0
    re_admitted: int = 0
    tokens_per_s: float = 0.0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    draft_tokens: int = 0
    accepted_tokens: int = 0
    spec_accept_rate: float = 0.0
    shed: int = 0
    migrated_in: int = 0
    migrated_out: int = 0
    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0
    tpot_p50_ms: float = 0.0
    tpot_p99_ms: float = 0.0
    queue_wait_p99_ms: float = 0.0
    rejected: int = 0
    timed_out: int = 0
    poisoned: int = 0
    prefix_hit_rate: float = 0.0
    prefill_tokens_saved: int = 0
    trie_pages: int = 0
    dedup_ratio: float = 1.0
    role: str = "unified"
    handoffs_in: int = 0
    handoffs_out: int = 0
    handoff_bytes: int = 0
    handoff_ms_p99: float = 0.0
    hists: str = ""
    ts: float = 0.0


@telemetry_record
class ScaleDecisionRecord:
    """One serving-autoscaler decision (``master/serving_autoscaler.py``).

    ``direction`` is "out" (a warm replica joined ``role``'s pool), "in"
    (the least-loaded member drained and detached) or "" (a latched
    breach cleared); ``signal`` names the gate that drove it, with
    ``value`` the reading against ``target``. ``reaction_s`` is breach
    edge → decision applied; ``version`` the master's serving-scale
    directive version (0 when the scaler versioned locally);
    ``replica`` the joiner or the drained victim."""

    role: str = "unified"
    direction: str = ""
    signal: str = ""
    value: float = 0.0
    target: float = 0.0
    n_before: int = 0
    n_after: int = 0
    version: int = 0
    reaction_s: float = 0.0
    replica: str = ""
    reason: str = ""
    ts: float = 0.0


class JsonlSink:
    """Append one ``to_json`` line per record (line-buffered, so records
    survive the process dying mid-failover)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._lock = threading.Lock()

    def emit(self, record) -> None:
        with self._lock:
            self._f.write(record.to_json() + "\n")

    def close(self) -> None:
        with self._lock:
            self._f.close()


# the JAX maps, for the record types the port registers: gauges and
# counters for any collector with inc(name) and set_gauge(name, value)
_GAUGE_MAP: Dict[str, List[Tuple[str, str]]] = {
    "StepRecord": [
        ("telemetry_step_time_s", "step_time_s"),
        ("telemetry_loss", "loss"),
        ("telemetry_tokens_per_s", "tokens_per_s"),
    ],
    "PlanRecord": [
        ("plan_suggested_bucket_mb", "suggested_bucket_mb"),
        ("plan_exposed_collective_us", "planned_exposed_us"),
        ("plan_hidden_collective_us", "planned_hidden_us"),
    ],
    "CheckpointRecord": [("ckpt_last_seconds", "seconds")],
    "ResourceRecord": [
        ("hbm_used_mb", "hbm_mb"),
        ("hbm_peak_mb", "hbm_peak_mb"),
    ],
    "StragglerRecord": [("straggler_lag_steps", "lag_steps")],
    "AnomalyRecord": [("anomaly_last_step", "step")],
    "ServingRecord": [
        ("serving_tokens_per_s", "tokens_per_s"),
        ("serving_p50_ms", "p50_ms"),
        ("serving_p99_ms", "p99_ms"),
        ("serving_queue_depth", "queue_depth"),
        ("serving_draft_tokens", "draft_tokens"),
        ("serving_accepted_tokens", "accepted_tokens"),
        ("serving_spec_accept_rate", "spec_accept_rate"),
        ("serving_shed", "shed"),
        ("serving_migrated_in", "migrated_in"),
        ("serving_migrated_out", "migrated_out"),
        ("serving_ttft_p50_ms", "ttft_p50_ms"),
        ("serving_ttft_p99_ms", "ttft_p99_ms"),
        ("serving_tpot_p50_ms", "tpot_p50_ms"),
        ("serving_tpot_p99_ms", "tpot_p99_ms"),
        ("serving_queue_wait_p99_ms", "queue_wait_p99_ms"),
        ("serving_rejected", "rejected"),
        ("serving_timed_out", "timed_out"),
        ("serving_poisoned", "poisoned"),
        ("serving_prefix_hit_rate", "prefix_hit_rate"),
        ("serving_prefill_tokens_saved", "prefill_tokens_saved"),
        ("serving_trie_pages", "trie_pages"),
        ("serving_dedup_ratio", "dedup_ratio"),
        ("serving_handoffs_in", "handoffs_in"),
        ("serving_handoffs_out", "handoffs_out"),
        ("serving_handoff_bytes", "handoff_bytes"),
        ("serving_handoff_ms_p99", "handoff_ms_p99"),
    ],
    "ScaleDecisionRecord": [
        ("autoscale_pool_size", "n_after"),
        ("autoscale_reaction_s", "reaction_s"),
    ],
    # cluster/brain.py records (registered on its import)
    "TuningPlan": [
        ("tuning_version", "version"),
        ("tuning_comm_bucket_mb", "comm_bucket_mb"),
        ("tuning_spec_k", "spec_k"),
        ("tuning_prefill_chunk", "prefill_chunk"),
    ],
    "JobMetrics": [
        ("brain_steps_per_sec", "steps_per_sec"),
        ("brain_samples_per_sec", "samples_per_sec"),
        ("brain_hbm_used_bytes", "hbm_used_bytes"),
    ],
}
_COUNTER_MAP: Dict[str, str] = {
    "ElasticEvent": "elastic_events_total",
    "NumericEvent": "numeric_events_total",
    "CheckpointRecord": "ckpt_records_total",
    "StragglerRecord": "straggler_flags_total",
    "AnomalyRecord": "anomaly_records_total",
    "HealthSummary": "health_summaries_total",
    "ServingRecord": "serving_records_total",
    "ScaleDecisionRecord": "scale_decisions_total",
    "TuningPlan": "tuning_plans_total",
    "JobMetrics": "brain_job_metrics_total",
}


class MetricsSink:
    """Project records onto a Prometheus-style collector (anything with
    ``inc(name)`` and ``set_gauge(name, value)``: the master's
    ``JobMetricCollector``)."""

    def __init__(self, collector):
        self._c = collector

    def emit(self, record) -> None:
        tname = type(record).__name__
        for gauge, attr in _GAUGE_MAP.get(tname, ()):
            self._c.set_gauge(gauge, float(getattr(record, attr)))
        counter = _COUNTER_MAP.get(tname)
        if counter:
            self._c.inc(counter)
        if tname == "ElasticEvent" and record.seconds > 0 and record.kind:
            self._c.set_gauge(f"failover_{record.kind}_s", record.seconds)


class MasterSink:
    """Forward selected record types to the master over the agent↔master
    wire (``MasterClient.report_telemetry``). Per-step records stay off
    the wire by default: the master gets the steps through
    ``report_global_step``."""

    DEFAULT_TYPES = (
        "AnomalyRecord",
        "CheckpointRecord",
        "ElasticEvent",
        "NumericEvent",
        "OverlapDriftRecord",
        "PlanRecord",
        "TuningPlan",
    )

    def __init__(self, client, types: Optional[Tuple[str, ...]] = None):
        self._client = client
        self._types = frozenset(
            types if types is not None else self.DEFAULT_TYPES)

    def emit(self, record) -> None:
        if type(record).__name__ in self._types:
            self._client.report_telemetry(record.to_json())


class CallbackSink:
    """Deliver records to a plain callable."""

    def __init__(self, fn: Callable, types: Optional[Tuple[str, ...]] = None):
        self._fn = fn
        self._types = frozenset(types) if types is not None else None

    def emit(self, record) -> None:
        if self._types is None or type(record).__name__ in self._types:
            self._fn(record)


class TelemetryHub:
    """Fan records out to attached sinks; a failing sink is detached
    after logging once, never propagated to the producer."""

    enabled = True

    def __init__(self):
        self._sinks: List = []
        self._lock = threading.Lock()

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def subscribe(self, fn: Callable,
                  types: Optional[Tuple[str, ...]] = None) -> CallbackSink:
        sink = CallbackSink(fn, types)
        self.add_sink(sink)
        return sink

    def publish(self, record) -> None:
        if not record.ts:
            record.ts = time.time()
        with self._lock:
            sinks = tuple(self._sinks)
        for sink in sinks:
            try:
                sink.emit(record)
            except Exception as e:  # noqa: BLE001 — sinks never break training
                logger.warning("telemetry sink %s failed (%s); detaching",
                               type(sink).__name__, e)
                self.remove_sink(sink)


class _NullHub:
    """Disabled hub: ``enabled`` is False and ``publish`` does nothing."""

    __slots__ = ()
    enabled = False

    def publish(self, record) -> None:
        pass

    def add_sink(self, sink) -> None:
        pass

    def remove_sink(self, sink) -> None:
        pass

    def subscribe(self, fn, types=None):
        return None


_NULL_HUB = _NullHub()
_hub: Optional[TelemetryHub] = None
_hub_lock = threading.Lock()


def configure_hub(sinks: Optional[List] = None,
                  jsonl_path: Optional[str] = None) -> TelemetryHub:
    """Install the process hub (idempotent: reconfiguring adds sinks);
    ``jsonl_path`` adds a ``JsonlSink`` writing there."""
    global _hub
    with _hub_lock:
        if _hub is None:
            _hub = TelemetryHub()
        for s in sinks or ():
            _hub.add_sink(s)
        if jsonl_path:
            _hub.add_sink(JsonlSink(jsonl_path))
        return _hub


def get_hub():
    """The process hub, or the no-op hub when none is configured. With
    ``DLROVER_TPU_TELEMETRY_DIR`` set the first call installs one with a
    JSONL sink there (one file a process, named by
    ``DLROVER_TPU_TRACE_ROLE``)."""
    if _hub is not None:
        return _hub
    tdir = os.getenv(GraftEnv.TELEMETRY_DIR)
    if tdir:
        role = os.getenv(GraftEnv.TRACE_ROLE, "proc")
        return configure_hub(jsonl_path=os.path.join(
            tdir, f"telemetry-{role}-{os.getpid()}.jsonl"))
    return _NULL_HUB


def reset_hub() -> None:
    """Drop the installed hub (tests)."""
    global _hub
    with _hub_lock:
        _hub = None
