"""Threaded request queue for the generation server.

Pure host-side Python (no jax import): a priority heap ordered by
(priority, arrival) — lower priority value first, FIFO within a class —
with admission control (bounded depth → ``AdmissionError``), and
latency accounting that publishes ``ServingRecord`` telemetry on the
shared ``TelemetryHub``. The engine pops work at step boundaries; user
threads submit concurrently.

Re-admission (``re_admit``) keeps a request's ORIGINAL arrival ticket:
a request bumped by allocator pressure or replica failover re-enters
ahead of later arrivals instead of going to the back of the line — the
elastic story's no-starvation guarantee.

Latency accounting is four mergeable log-bucketed histograms
(observability/histogram.py), one per phase:

- ``e2e``       — submit → complete, the classic request latency;
- ``ttft``      — submit → first emitted token (prefill + queue);
- ``tpot``      — mean inter-token ms within one request (decode pace);
- ``queue_wait``— (re-)enqueue → engine admission.

Histograms replace the old truncating flat list: O(1) record, no
window bias under sustained load, and the router/master merge replica
histograms bucket-by-bucket so fleet percentiles are computed from
counts, never from averaged per-replica percentiles. Every dropped
request lands in exactly one of ``shed`` / ``rejected`` /
``timed_out`` / ``poisoned`` so goodput vs offered load is computable.

The port's copy of ``dlrover_tpu/serving/scheduler.py``, unchanged but
for its imports. One difference in meaning: ``SamplingParams.seed``
keys the port's counter-based sampler (``models/generate.py``), not a
threefry key, so a sampled stream is deterministic per seed in each
package but the two packages draw different tokens.
"""

import heapq
import itertools
import json
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.observability.histogram import LatencyHistogram
from dlrover_tpu_torch.observability.telemetry import ServingRecord
from dlrover_tpu_torch.observability.tracing import get_tracer

#: phase keys of the scheduler's latency histograms, in envelope order
LATENCY_PHASES = ("e2e", "ttft", "tpot", "queue_wait", "handoff")


class AdmissionError(ValueError):
    """The request cannot be admitted: queue at capacity or shed under
    migration pressure (back off ``retry_after_s`` and retry), or
    invalid parameters (fix the request). Subclasses ValueError so
    pre-existing callers catching ValueError on the future still work.

    ``retry_after_s`` is the scheduler's deadline-aware hint — estimated
    queue drain time from the recent completion rate, 0.0 when the
    error is not load-related (invalid parameters)."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy carried on the ``Request``.

    ``temperature=0`` is greedy (argmax); ``temperature>0`` draws from
    ``warp_logits(...)`` by Gumbel-max with noise keyed on (``seed``,
    absolute position of the token being drawn) — deterministic given
    the seed and STABLE across admit/evict reordering and batch
    composition, because no engine step counter or slot index enters
    the draw. ``top_k=0`` / ``top_p=1.0`` disable those warps.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def validate(self) -> None:
        """Raise ``AdmissionError`` on out-of-domain parameters. The
        engine calls this at ADMISSION (not submit) so a poisoned
        request fails its own future instead of killing the step-loop
        thread."""
        if not (self.temperature >= 0.0):  # catches NaN too
            raise AdmissionError(
                f"temperature must be >= 0, got {self.temperature}"
            )
        if self.top_k < 0:
            raise AdmissionError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):  # catches NaN too
            raise AdmissionError(
                f"top_p must be in (0, 1], got {self.top_p}"
            )


@dataclass
class Request:
    """One generation request as the engine sees it."""

    rid: str
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    priority: int = 0
    arrival: int = 0            # admission ticket, stable across re-admits
    submit_t: float = 0.0
    last_enqueue_t: float = 0.0  # refreshed on re-admit (queue-wait base)
    first_token_t: float = 0.0  # 0 until the prefill emits token 0
    done_t: float = 0.0
    deadline_s: Optional[float] = None  # wall budget from submit_t, if any
    re_admits: int = 0          # >0 marks preempted/migrated — never shed
    sampling: SamplingParams = field(default_factory=SamplingParams)
    future: Future = field(default_factory=Future)

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens


class Scheduler:
    """Thread-safe request queue + latency bookkeeping for ONE engine."""

    def __init__(
        self,
        *,
        max_queue: int = 256,
        max_latencies: int = 4096,
        hub=None,
        replica: str = "replica-0",
    ):
        self._heap: list = []
        self._lock = threading.Lock()
        self._ticket = itertools.count()
        # heap tiebreak: arrival tickets are per-scheduler, so a request
        # RE-ADMITTED from a dead peer can tie a local one exactly —
        # and Request is deliberately not orderable
        self._seq = itertools.count()
        self.max_queue = max_queue
        self.hub = hub
        self.replica = replica
        # max_latencies is kept for signature compatibility only: the
        # histograms are O(1)-bounded by geometry, not by sample count
        self._max_latencies = max_latencies
        self._hists: Dict[str, LatencyHistogram] = {
            k: LatencyHistogram() for k in LATENCY_PHASES
        }
        self._done_ts: List[float] = []  # recent completion times, for hints
        self.admitted = 0
        self.completed = 0
        self.re_admitted = 0
        self.shed = 0
        self.rejected = 0   # admission failures: capacity + oversize
        self.timed_out = 0  # per-request deadline expiries
        self.poisoned = 0   # invalid sampling parameters

    # ---- intake ----------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        eos_id: Optional[int] = None,
        priority: int = 0,
        sampling: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
    ) -> Request:
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        with self._lock:
            if len(self._heap) >= self.max_queue:
                self.rejected += 1
                raise AdmissionError(
                    f"queue at capacity ({self.max_queue}); retry later",
                    retry_after_s=self._retry_after_locked(),
                )
            arrival = next(self._ticket)
            now = time.monotonic()
            req = Request(
                rid=f"{self.replica}/r{arrival}",
                prompt=[int(t) for t in prompt],
                max_new_tokens=int(max_new_tokens),
                eos_id=eos_id,
                priority=int(priority),
                arrival=arrival,
                submit_t=now,
                last_enqueue_t=now,
                deadline_s=deadline_s,
                sampling=sampling or SamplingParams(),
            )
            heapq.heappush(
                self._heap,
                (req.priority, req.arrival, next(self._seq), req),
            )
            self.admitted += 1
        return req

    def re_admit(self, req: Request) -> None:
        """Re-queue a preempted/failed-over request under its ORIGINAL
        (priority, arrival) ticket — it outranks later arrivals. The
        admission-control bound is deliberately not applied: the request
        was already admitted once. Marks the request shed-exempt."""
        with self._lock:
            req.re_admits += 1
            req.last_enqueue_t = time.monotonic()
            heapq.heappush(
                self._heap,
                (req.priority, req.arrival, next(self._seq), req),
            )
            self.re_admitted += 1
        tr = get_tracer()
        if tr.enabled:
            tr.instant(
                "serving.re_admit", rid=req.rid, replica=self.replica,
                re_admits=req.re_admits,
            )

    # ---- overload degradation --------------------------------------------

    def _retry_after_locked(self) -> float:
        """Estimated queue drain time from the recent completion rate —
        the ``AdmissionError.retry_after_s`` hint. Caller holds _lock."""
        depth = len(self._heap)
        ts = self._done_ts
        if len(ts) >= 2 and ts[-1] > ts[0]:
            rate = (len(ts) - 1) / (ts[-1] - ts[0])
            est = (depth + 1) / rate
        else:
            est = 1.0
        return min(30.0, max(0.05, est))

    def retry_after_hint(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    def shed_lowest(
        self,
        count: int = 1,
        below_priority: Optional[int] = None,
    ) -> List[Request]:
        """Shed up to ``count`` of the LOWEST-priority queued new
        admissions: fail their futures with a retry-after-carrying
        ``AdmissionError`` so callers back off instead of hammering a
        replica absorbing a failover. Never sheds a re-admitted request
        (``re_admits > 0`` — it already paid for its place once, and
        shedding it would turn a migration fallback into a lost
        request). ``below_priority`` restricts victims to strictly
        lower-priority (numerically greater) classes, so migration
        admission never sheds traffic it doesn't outrank."""
        with self._lock:
            cands = [
                t
                for t in self._heap
                if t[-1].re_admits == 0 and not t[-1].future.done()
            ]
            if below_priority is not None:
                cands = [t for t in cands if t[0] > below_priority]
            cands.sort(reverse=True)  # worst (priority, arrival) first
            victims = cands[: max(int(count), 0)]
            if victims:
                drop = {id(t[-1]) for t in victims}
                self._heap = [t for t in self._heap if id(t[-1]) not in drop]
                heapq.heapify(self._heap)
                self.shed += len(victims)
            hint = self._retry_after_locked()
        shed = [t[-1] for t in victims]
        for req in shed:
            self.fail(
                req,
                AdmissionError(
                    f"{req.rid} shed under migration pressure; "
                    f"retry after {hint:.2f}s",
                    retry_after_s=hint,
                ),
            )
        return shed

    # ---- engine side -----------------------------------------------------

    def pop_next(
        self, can_admit=None, lookahead: int = 0
    ) -> Optional[Request]:
        """Pop the highest-priority request, or None when empty or when
        ``can_admit(req)`` rejects the head (head-of-line admission:
        lower-ranked requests never jump a head waiting on pages).
        Requests whose wall deadline already expired in the queue are
        failed fast (counted ``timed_out``) instead of burning slot
        time on an answer nobody is waiting for.

        ``lookahead > 0`` relaxes strict head-of-line when the head is
        BLOCKED: up to ``lookahead`` requests behind it are offered to
        ``can_admit`` in heap order and the first admissible one is
        popped. With a hit-aware ``can_admit`` (prefix sharing) this
        lets a cheap hot-prefix request — whose resident prefix pages
        cost nothing from the free list — run instead of idling a slot
        behind an expensive cold request. The head keeps its ticket and
        is re-offered first on every later call, so it is delayed only
        while it cannot run anyway — never starved by the jumpers."""
        expired: List[Request] = []
        got: Optional[Request] = None
        with self._lock:
            now = time.monotonic()
            while self._heap:
                req = self._heap[0][-1]
                if req.future.cancelled():
                    heapq.heappop(self._heap)
                    continue
                if (
                    req.deadline_s is not None
                    and now - req.submit_t > req.deadline_s
                ):
                    heapq.heappop(self._heap)
                    self.timed_out += 1
                    expired.append(req)
                    continue
                if can_admit is not None and not can_admit(req):
                    if lookahead > 0:
                        got = self._pop_lookahead_locked(
                            can_admit, lookahead, now
                        )
                    break
                heapq.heappop(self._heap)
                got = req
                break
        for req in expired:
            self.fail(
                req,
                AdmissionError(
                    f"{req.rid} deadline ({req.deadline_s}s) expired "
                    f"in queue"
                ),
            )
        return got

    def _pop_lookahead_locked(
        self, can_admit, lookahead: int, now: float
    ) -> Optional[Request]:
        """Scan up to ``lookahead`` requests behind a blocked head (heap
        order) and pop the first one ``can_admit`` accepts. Cancelled /
        expired candidates are skipped in place — the head pass owns
        their bookkeeping. Caller holds ``_lock``."""
        for t in heapq.nsmallest(lookahead + 1, self._heap)[1:]:
            req = t[-1]
            if req.future.cancelled() or req.future.done():
                continue
            if (
                req.deadline_s is not None
                and now - req.submit_t > req.deadline_s
            ):
                continue
            if can_admit(req):
                self._heap.remove(t)
                heapq.heapify(self._heap)
                return req
        return None

    def record_admitted(self, req: Request) -> None:
        """Engine-side admission hook: close the queue-wait interval
        (enqueue → admission) into the histogram and the trace."""
        t0 = req.last_enqueue_t or req.submit_t
        wait_ms = max(0.0, (time.monotonic() - t0) * 1e3)
        with self._lock:
            self._hists["queue_wait"].record(wait_ms)
        tr = get_tracer()
        if tr.enabled:
            tr.complete_span(
                "serving.queue_wait", t0, rid=req.rid,
                replica=self.replica, priority=req.priority,
            )

    def count_rejected(self) -> None:
        """An admission-rejected request (engine oversize check)."""
        with self._lock:
            self.rejected += 1

    def count_poisoned(self) -> None:
        """A request failed for invalid sampling parameters."""
        with self._lock:
            self.poisoned += 1

    def count_timed_out(self) -> None:
        """A request that missed its wall deadline outside the queue
        (the router's waiter observed the expiry)."""
        with self._lock:
            self.timed_out += 1

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def peek(self, n: int = 1) -> List[Request]:
        """Non-destructive head-of-line peek: the next ``n`` LIVE
        requests in pop order. Cancelled/resolved entries are skipped
        without consuming the lookahead budget — the scan walks the heap
        in sorted order until ``n`` live requests are collected, so a
        burst of cancellations at the head can't blind the prefetcher to
        queued work further back. The lookahead prefetcher reads queued
        prompts here to warm caches (tiered embedding rows) before the
        engine pops them; the queue itself is untouched."""
        n = max(int(n), 0)
        out: List[Request] = []
        with self._lock:
            if n:
                for t in sorted(self._heap):
                    if not t[-1].future.done():
                        out.append(t[-1])
                        if len(out) == n:
                            break
        return out

    def record_first_token(self, req: Request) -> None:
        """Stamp TTFT once per request — a re-prefilled failover does
        not reset the clock the user has been watching since submit."""
        if req.first_token_t:
            return
        req.first_token_t = time.monotonic()
        with self._lock:
            self._hists["ttft"].record(
                max(0.0, (req.first_token_t - req.submit_t) * 1e3)
            )

    def record_handoff_ms(self, ms: float) -> None:
        """One prefill→decode handoff's wire time (first fragment export
        to reservation commit), recorded on the RECEIVING replica's
        scheduler so the decode pool's handoff_ms_p99 is the admission
        latency its streams actually pay."""
        with self._lock:
            self._hists["handoff"].record(max(0.0, ms))

    def complete(self, req: Request, output) -> None:
        """Resolve a request exactly once and record its latency."""
        req.done_t = time.monotonic()
        with self._lock:
            self.completed += 1
            self._hists["e2e"].record((req.done_t - req.submit_t) * 1e3)
            # inter-token pace: mean decode-token spacing after token 0
            n_new = len(output) - len(req.prompt) if output else 0
            if req.first_token_t and n_new >= 2:
                self._hists["tpot"].record(
                    max(0.0, req.done_t - req.first_token_t)
                    / (n_new - 1) * 1e3
                )
            self._done_ts.append(req.done_t)
            if len(self._done_ts) > 256:
                del self._done_ts[:-256]
        if not req.future.done():
            req.future.set_result(output)

    def fail(self, req: Request, exc: Exception) -> None:
        if not req.future.done():
            req.future.set_exception(exc)

    # ---- accounting ------------------------------------------------------

    def histograms(self) -> Dict[str, LatencyHistogram]:
        """Consistent copies of the per-phase histograms, keyed by
        ``LATENCY_PHASES`` — what the router/master merge for fleet
        percentiles."""
        with self._lock:
            return {k: h.copy() for k, h in self._hists.items()}

    def latency_ms(self) -> dict:
        """End-to-end latency percentiles, in the historical
        ``{p50, p99, n}`` shape — now backed by the histogram, so no
        window truncation and no per-call sort."""
        with self._lock:
            return self._hists["e2e"].summary()

    def latency_summary(self) -> dict:
        """Flat per-phase percentile summary (the bench/record shape)."""
        h = self.histograms()
        out = h["e2e"].summary()
        out.update(
            ttft_p50_ms=h["ttft"].percentile(50.0),
            ttft_p99_ms=h["ttft"].percentile(99.0),
            tpot_p50_ms=h["tpot"].percentile(50.0),
            tpot_p99_ms=h["tpot"].percentile(99.0),
            queue_wait_p99_ms=h["queue_wait"].percentile(99.0),
        )
        return out

    def reset_latencies(self) -> None:
        """Drop warmup samples (compile time) before a timed window."""
        with self._lock:
            for h in self._hists.values():
                h.clear()

    def publish(self, engine_stats: Optional[dict] = None):
        """Emit one ``ServingRecord`` on the hub; returns the record
        (also when no hub is attached, for callers that sink it
        themselves)."""
        hists = self.histograms()
        lat = hists["e2e"].summary()
        es = engine_stats or {}
        rec = ServingRecord(
            replica=self.replica,
            active_slots=int(es.get("active_slots", 0)),
            queue_depth=self.queue_depth(),
            admitted=self.admitted,
            completed=self.completed,
            re_admitted=self.re_admitted,
            tokens_per_s=float(es.get("tokens_per_s", 0.0)),
            p50_ms=round(lat["p50"], 3),
            p99_ms=round(lat["p99"], 3),
            draft_tokens=int(es.get("draft_tokens", 0)),
            accepted_tokens=int(es.get("accepted_tokens", 0)),
            spec_accept_rate=float(es.get("spec_accept_rate", 0.0)),
            shed=self.shed,
            migrated_in=int(es.get("migrated_in", 0)),
            migrated_out=int(es.get("migrated_out", 0)),
            ttft_p50_ms=round(hists["ttft"].percentile(50.0), 3),
            ttft_p99_ms=round(hists["ttft"].percentile(99.0), 3),
            tpot_p50_ms=round(hists["tpot"].percentile(50.0), 3),
            tpot_p99_ms=round(hists["tpot"].percentile(99.0), 3),
            queue_wait_p99_ms=round(
                hists["queue_wait"].percentile(99.0), 3
            ),
            rejected=self.rejected,
            timed_out=self.timed_out,
            poisoned=self.poisoned,
            prefix_hit_rate=float(es.get("prefix_hit_rate", 0.0)),
            prefill_tokens_saved=int(es.get("prefill_tokens_saved", 0)),
            trie_pages=int(es.get("trie_pages", 0)),
            dedup_ratio=float(es.get("dedup_ratio", 1.0)),
            role=str(es.get("role", "unified")),
            handoffs_in=int(es.get("handoffs_in", 0)),
            handoffs_out=int(es.get("handoffs_out", 0)),
            handoff_bytes=int(es.get("handoff_bytes", 0)),
            handoff_ms_p99=round(hists["handoff"].percentile(99.0), 3),
            hists=json.dumps(
                {k: hists[k].to_dict() for k in LATENCY_PHASES},
                sort_keys=True,
            ),
        )
        if self.hub is not None:
            self.hub.publish(rec)
        return rec
