"""The serving replica's telemetry record.

A copy of ``ServingRecord`` from ``dlrover_tpu/observability/telemetry.py``
with the same fields and the same ``to_json`` envelope, so a record the
port publishes reads back through the JAX package's ``from_json``. The
hub and its sinks stay in the JAX package for now: ``Scheduler.publish``
hands the record to any ``hub`` object with a ``publish`` method.
"""

import dataclasses
import json


@dataclasses.dataclass
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

    def to_json(self) -> str:
        return json.dumps(
            {"r": type(self).__name__, "d": dataclasses.asdict(self)},
            sort_keys=True,
        )
