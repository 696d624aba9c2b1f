"""Telemetry records and the hub that fans them out.

Copies of the JAX package's records (``dlrover_tpu/observability/
telemetry.py``) with the same fields and the same ``to_json`` envelope,
so a record the port publishes reads back through the JAX package's
``from_json``: the trainer's ``StepRecord``, the checkpoint engine's
``CheckpointRecord``, ``ElasticEvent``, the loss-spike detector's
``NumericEvent``, the serving replica's ``ServingRecord``, the
master speed monitor's ``StragglerRecord`` and the agent monitor's
``ResourceRecord`` (the master publishes it; the diagnosis manager
reads it). The hub
keeps the JAX contract: ``get_hub()`` is a no-op hub whose ``enabled``
is False until ``configure_hub`` installs one, so producers guard with
``if hub.enabled:`` and a disabled hub costs one attribute read. The
sinks (JSONL files, metrics, the master) stay in the JAX package for
now (ROADMAP A12); ``subscribe`` hands records to a callable.
"""

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

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
class CheckpointRecord:
    """One save/restore action at any tier of the checkpoint stack."""

    kind: str = ""  # save_memory | persist | persist_wait | restore
    step: int = -1
    seconds: float = 0.0
    nbytes: int = 0
    ok: bool = True
    tier: str = ""  # memory | storage
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


def configure_hub(sinks: Optional[List] = None) -> TelemetryHub:
    """Install the process hub (idempotent: reconfiguring adds sinks)."""
    global _hub
    with _hub_lock:
        if _hub is None:
            _hub = TelemetryHub()
        for s in sinks or ():
            _hub.add_sink(s)
        return _hub


def get_hub():
    """The process hub, or the no-op hub when none is configured."""
    return _hub if _hub is not None else _NULL_HUB


def reset_hub() -> None:
    """Drop the installed hub (tests)."""
    global _hub
    with _hub_lock:
        _hub = None
