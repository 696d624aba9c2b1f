"""Disaggregated prefill/decode serving: the streaming handoff.

Port of ``dlrover_tpu/serving/disagg.py``. On a unified replica every
admitted prompt runs its prefill chunks on the decode path, coupling
TTFT to TPOT. Split, prefill-role engines run chunked prefill only and
ship each finished prompt to a decode-role engine whose step is pure
batched decode. The transport is the migration wire
(``serving/migration.py``: ``RequestSnapshot`` → checksummed blob →
``import_slot``); what is new is the schedule (fragments stream per
committed chunk, overlapped with the next chunk's compute) and the
snapshot's ``page_start`` offset.

One handoff::

    prefill engine loop                    coordinator worker
    -------------------                    ------------------
    chunk 0 commits ──sink──▶ pages[0,k) ─▶ reserve on a decode replica
    chunk 1 commits ──sink──▶ pages[k,m) ─▶ encode, verify, stage_pages
    ...                                    ...
    last chunk + token 0 ──▶ final pages ▶ stage + import_slot(commit)
    slot parks phase="handoff"             repoint router, release donor

The sink runs on the prefill loop's thread and does only the device →
host copy (``export_pages``); the CRC and the encode run on the
coordinator's thread, so the loop's next chunk waits for nothing else.
Staging a fragment does not park the decode loop (the JAX coordinator
pauses it, since its pools are rebound): the reservation's pages are
in no block table, and the port writes them in place on the loop's
stream. Only the commit, which takes a lane, pauses it.
The pages ship exactly as stored and every draw is keyed on seed and
absolute position, so the decode continuation is the unified stream —
given the same ``prefill_chunk`` on both sides.

Exactly once under faults — the coordinator lock guards a per-request
``committed``/``cancelled`` pair:

- torn fragment (``TornPageTransfer``) → re-export the same logical
  range from the donor (committed pages are immutable) up to ``retries``
  times, then degrade: abort the reservation, release the donor slot,
  re-dispatch under the ORIGINAL ticket through the router's prefill
  pool.
- dead decode target before the commit → restart the whole stream on
  another decode replica (staging is offset-addressed, so a replay
  rewrites the same cells). A fragment that finds its target reset
  replays from page 0 itself: the restart queued at the death can come
  after the request's final fragment, which would otherwise commit a
  reservation missing the pages staged on the dead replica (the JAX
  coordinator's race).
- dead prefill donor → ``resolve_dead_donor``: a committed handoff
  returns its owner (the router repoints, no re-admit); an in-flight one
  is cancelled atomically and the router re-dispatches.
- ``local_done`` (the prompt finished at its first token) → cancel the
  fragments already streamed, abort the reservation.

Lock order: router lock → coordinator lock is the only compound order;
the sink takes only the coordinator lock; the worker never holds the
coordinator lock while pausing a PREFILL replica (whose loop runs the
sink) or while taking the router lock.

Fault point: ``serving.handoff`` (rank = the donor's node_id), checked
before each fragment's decode.
"""

import queue
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.comm import _backoff_delay
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.elastic.faults import (
    FaultInjector,
    TornDonation,
    get_injector,
)
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.serving.migration import (
    RequestSnapshot,
    ServingMigrator,
    decode_snapshot,
    encode_snapshot,
    geometry_fingerprint,
)
from dlrover_tpu_torch.serving.scheduler import AdmissionError

logger = get_logger(__name__)


class HandoffError(RuntimeError):
    """A handoff cannot proceed (no decode capacity, the donor slot
    gone): the coordinator degrades it to re-prefill, never loses it."""


def snapshot_fragment(
    engine, i: int, s, start: int, stop: int, *, final: bool
) -> RequestSnapshot:
    """One streaming-handoff fragment: pages ``[start, stop)`` of slot
    ``i`` plus the resume metadata. Mid-stream fragments carry
    ``phase="prefill"`` and no generated tokens; the final one carries
    the resume state (``phase="decode"``, token 0), so the receiver
    commits straight into a decode lane."""
    return RequestSnapshot(
        rid=s.req.rid,
        prompt=[int(t) for t in s.prompt],
        generated=list(s.generated) if final else [],
        n_prefilled=int(s.n_prefilled) if final else 0,
        phase="decode" if final else "prefill",
        max_new_tokens=int(s.req.max_new_tokens),
        seed=int(s.req.sampling.seed),
        page_start=int(start),
        pages=engine.export_pages(i, start, stop),
        **geometry_fingerprint(engine.geom),
    )


class _Handoff:
    """One request's prefill → decode transfer state."""

    __slots__ = (
        "rid", "req", "donor", "slot", "target", "reserved", "shipped",
        "committed", "cancelled", "t0", "bytes", "fragments",
    )

    def __init__(self, rid, req, donor, slot):
        self.rid = rid
        self.req = req
        self.donor = donor          # ServingReplica (prefill role)
        self.slot = slot            # donor slot index
        self.target = None          # ServingReplica (decode role)
        self.reserved = False
        self.shipped = 0            # logical pages exported so far
        self.committed = False
        self.cancelled = False
        self.t0 = time.monotonic()
        self.bytes = 0
        self.fragments = 0


class HandoffCoordinator:
    """Streams finished prompts from the prefill pool into decode-pool
    reservations and commits each exactly once.

    The donor side runs on each prefill engine's loop thread (the
    ``handoff_sink`` hook: export only); one daemon worker thread does
    the rest (reservation, encode and CRC, staging, commit, degrade).
    ``fragment_log`` holds one entry a staged fragment: its pages and
    wire bytes, the export's ms on the loop thread, the encode and
    verify ms, the stage's ms and the ms from export to staged."""

    def __init__(
        self,
        prefill_pool: List,
        decode_pool: List,
        *,
        router=None,
        faults: Optional[FaultInjector] = None,
        streaming: bool = True,
        reserve_attempts: int = 6,
        retries: int = 1,
        shed_per_attempt: int = 2,
    ):
        self.prefill_pool = list(prefill_pool)
        self.decode_pool = list(decode_pool)
        self.router = router
        self.faults = faults if faults is not None else get_injector()
        self.streaming = streaming
        self.reserve_attempts = reserve_attempts
        self.retries = retries
        self.shed_per_attempt = shed_per_attempt
        self._lock = threading.Lock()
        self._by_rid: Dict[str, _Handoff] = {}
        self._q: "queue.Queue" = queue.Queue()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._disabled = False
        self.degraded = 0           # handoffs that fell to re-prefill
        self.completed = 0          # handoffs committed
        self.retried = 0            # torn fragments re-exported
        self.fragment_log: List[Dict] = []

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> "HandoffCoordinator":
        for rep in self.prefill_pool:
            rep.server.engine.handoff_sink = self._make_sink(rep)
        self._thread = threading.Thread(
            target=self._worker_loop, name="handoff-coordinator", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, join: bool = True) -> None:
        self._stop_evt.set()
        if join and self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def pending(self) -> int:
        with self._lock:
            return sum(
                1 for h in self._by_rid.values()
                if not h.committed and not h.cancelled
            )

    # ---- donor side (prefill engine loop thread) -------------------------

    def _make_sink(self, rep):
        def sink(i, s, event):
            if self._disabled:
                return
            rid = s.req.rid
            if event == "local_done":
                self._q.put(("cancel", rid, None))
                return
            if event == "chunk" and not self.streaming:
                return
            eng = rep.server.engine
            with self._lock:
                h = self._by_rid.get(rid)
                if h is None:
                    h = _Handoff(rid, s.req, rep, i)
                    self._by_rid[rid] = h
                if h.cancelled:
                    return
                start = h.shipped
            if event == "chunk":
                # only FULL pages are immutable mid-prompt; a partial
                # tail page still collects rows from later chunks
                stop = s.n_prefilled // eng.geom.page_size
                final = False
            else:  # "done": the slot just parked in phase "handoff"
                stop = eng.alloc.slot_pages(i)
                final = True
            if stop <= start and not final:
                return
            t0 = time.monotonic()
            snap = snapshot_fragment(eng, i, s, start, stop, final=final)
            export_ms = (time.monotonic() - t0) * 1e3
            with self._lock:
                h.shipped = max(h.shipped, stop)
            self._q.put(("frag", rid, (snap, final, t0, export_ms)))
        return sink

    # ---- worker side -----------------------------------------------------

    def _worker_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                kind, rid, payload = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                if kind == "cancel":
                    self._handle_cancel(rid)
                elif kind == "restart":
                    self._handle_restart(rid)
                else:
                    self._handle_fragment(rid, *payload)
            except Exception as e:  # noqa: BLE001 — degrade, never wedge
                logger.warning("handoff of %s degraded: %s", rid, e)
                self._degrade(rid)

    def _get(self, rid: str) -> Optional[_Handoff]:
        with self._lock:
            h = self._by_rid.get(rid)
            if h is None or h.cancelled or h.committed:
                return None
            return h

    def _handle_fragment(self, rid, snap, final, t_export, export_ms) -> None:
        h = self._get(rid)
        if h is None:
            return
        if h.target is None:
            if snap.page_start > 0:
                # the pages before this fragment went to a decode replica
                # that died since: replay the stream from page 0 now (the
                # restart queued at the death may come after this
                # request's final fragment)
                self._handle_restart(rid)
                return
            self._reserve(h)
        # the target as of now: on_replica_dead may reset h.target from
        # the router's thread while this fragment is in hand
        tgt = h.target
        t0 = time.monotonic()
        blob = encode_snapshot(snap)
        got = self._decode_with_retry(h, blob, snap, final)
        if got is None:
            return  # cancelled under our feet
        blob, snap = got
        wire_ms = (time.monotonic() - t0) * 1e3
        ServingMigrator._check_geometry(snap, tgt.server.engine)
        t1 = time.monotonic()
        # no pause: the reserved pages are in no block table, so the
        # decode loop neither reads nor writes them while they land
        tgt.server.engine.stage_pages(rid, snap.page_start, snap.pages)
        t2 = time.monotonic()
        h.bytes += len(blob)
        h.fragments += 1
        h.donor.server.engine.note_handoff_bytes(len(blob))
        self.fragment_log.append({
            "rid": rid, "pages": snap.n_pages, "bytes": len(blob),
            "export_ms": export_ms, "wire_ms": wire_ms,
            "stage_ms": (t2 - t1) * 1e3, "ms": (t2 - t_export) * 1e3,
        })
        if final:
            self._commit(h, tgt, snap)

    def _decode_with_retry(self, h, blob, snap, final):
        """Verify a fragment blob; a torn one is re-exported from the
        donor (its pages are immutable, so the re-export is the same
        bytes) up to ``retries`` times. Returns (blob, snapshot)."""
        start = snap.page_start
        stop = start + snap.n_pages
        for attempt in range(self.retries + 1):
            try:
                self.faults.at("serving.handoff", rank=h.donor.node_id)
                return blob, decode_snapshot(blob)
            except TornDonation as e:
                if attempt >= self.retries:
                    raise
                self.retried += 1
                logger.info(
                    "torn handoff fragment for %s (attempt %d): %s — "
                    "re-exporting pages [%d, %d)",
                    h.rid, attempt + 1, e, start, stop,
                )
                with h.donor.server.paused() as eng:
                    s = eng.slots[h.slot]
                    if s is None or s.req.rid != h.rid:
                        raise HandoffError(
                            f"donor slot for {h.rid} gone mid-retry"
                        ) from e
                    again = snapshot_fragment(
                        eng, h.slot, s, start, stop, final=final
                    )
                blob = encode_snapshot(again)
        return None  # unreachable

    #: how often a handoff waiting for a decode lane looks for one
    LANE_POLL_S = 0.005

    def commit_wait_s(self) -> float:
        """How long a staged handoff waits for a decode lane before it
        degrades: what ``reserve_attempts`` backoffs could sleep at most
        (the JAX coordinator sleeps them out; the port polls for the
        lane in between)."""
        return sum(min(15.0, 0.5 * 2 ** a)
                   for a in range(self.reserve_attempts))

    def _pick_target(self):
        live = [r for r in self.decode_pool if r.alive]
        if not live:
            return None
        return max(live, key=lambda r: r.server.engine.alloc.free_pages)

    def _reserve(self, h: _Handoff) -> None:
        """Hold the request's FULL footprint (prompt + generation) on the
        least-loaded live decode replica; page pressure sheds the
        target's lowest-priority queued new admissions and backs off, as
        the failover migrator does."""
        for attempt in range(self.reserve_attempts):
            tgt = self._pick_target()
            if tgt is None:
                raise HandoffError(f"no live decode replica for {h.rid}")
            with tgt.server.paused() as eng:
                ok = eng.alloc.reserve_for_migration(
                    h.rid, h.req.total_tokens
                )
            if ok:
                h.target = tgt
                h.reserved = True
                return
            tgt.server.scheduler.shed_lowest(
                count=self.shed_per_attempt, below_priority=h.req.priority
            )
            self._stop_evt.wait(_backoff_delay(attempt))
        raise HandoffError(
            f"no decode replica could reserve {h.req.total_tokens} tokens "
            f"for {h.rid} in {self.reserve_attempts} attempts"
        )

    def _commit(self, h: _Handoff, tgt, snap: RequestSnapshot) -> None:
        """Flip ownership: import the staged reservation into a decode
        lane of ``tgt``. Atomic against cancellation (the coordinator
        lock); a full lane table retries with backoff (the reservation
        already holds the pages, only a slot index is awaited). A target
        that died meanwhile (``h.target`` reset) leaves the handoff to
        its restart."""
        t_resume = time.monotonic()
        deadline = t_resume + self.commit_wait_s()
        while True:
            # a free lane, read without the pause (a hint: the import
            # decides), so a full replica is not parked to find out
            if None in tgt.server.engine.slots or not tgt.alive:
                with self._lock:
                    if h.cancelled or h.target is not tgt:
                        break
                    try:
                        with tgt.server.paused() as eng:
                            eng.import_slot(
                                h.req,
                                None,
                                phase="decode",
                                n_prefilled=snap.n_prefilled,
                                generated=snap.generated,
                                reserved_tag=h.rid,
                                handoff=True,
                            )
                        h.committed = True
                    except AdmissionError:
                        pass  # the lane went to another import
            if (h.committed or h.cancelled or h.target is not tgt
                    or time.monotonic() >= deadline):
                break
            self._stop_evt.wait(self.LANE_POLL_S)
        if not h.committed:
            if h.cancelled:
                self._abort_reservation(h)
                return
            if h.target is not tgt:
                return  # the target died: the restart replays the stream
            raise HandoffError(
                f"no free decode lane for {h.rid} on {tgt.name}"
            )
        # --- success, outside the coordinator lock ---
        dt_ms = (time.monotonic() - h.t0) * 1e3
        tgt.server.scheduler.record_handoff_ms(dt_ms)
        tr = get_tracer()
        if tr.enabled:
            tr.complete_span(
                "serving.handoff_transfer", h.t0, rid=h.rid,
                donor=h.donor.name, target=tgt.name,
                bytes=h.bytes, fragments=h.fragments,
            )
            tr.complete_span(
                "serving.handoff_resume", t_resume, rid=h.rid,
                replica=tgt.name, n_prefilled=snap.n_prefilled,
            )
        if self.router is not None:
            self.router._repoint(h.rid, tgt)
        with h.donor.server.paused() as eng:
            s = eng.slots[h.slot] if h.slot < len(eng.slots) else None
            if s is not None and s.req.rid == h.rid:
                eng.release_slot(h.slot, reason="handoff_out")
        with self._lock:
            self._by_rid.pop(h.rid, None)
        self.completed += 1
        logger.info(
            "handoff %s: %s → %s, %d fragments, %d bytes, %.1f ms",
            h.rid, h.donor.name, tgt.name, h.fragments, h.bytes, dt_ms,
        )

    def _handle_cancel(self, rid: str) -> None:
        """The prompt finished on the prefill replica (max_new=1, EOS at
        once): unwind the fragments already streamed."""
        with self._lock:
            h = self._by_rid.pop(rid, None)
            if h is None or h.committed:
                return
            h.cancelled = True
        self._abort_reservation(h)

    def _handle_restart(self, rid: str) -> None:
        """Replay a stream whose decode target died before the commit
        onto a fresh target: re-export what was shipped so far from the
        donor (readable off a dead donor too: a kill halts the loop, the
        pools stay) and run it through the fragment path."""
        h = self._get(rid)
        if h is None:
            return
        t0 = time.monotonic()
        with h.donor.server.paused() as eng:
            s = eng.slots[h.slot] if h.slot < len(eng.slots) else None
            if s is None or s.req.rid != rid:
                return  # slot already released or completed
            final = s.phase == "handoff"
            if final:
                stop = eng.alloc.slot_pages(h.slot)
            else:
                stop = s.n_prefilled // eng.geom.page_size
            snap = snapshot_fragment(eng, h.slot, s, 0, stop, final=final)
        export_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            h.shipped = max(h.shipped, stop)
        self._handle_fragment(rid, snap, final, t0, export_ms)

    def _abort_reservation(self, h: _Handoff) -> None:
        tgt = h.target
        if tgt is None or not h.reserved:
            return
        with tgt.server.paused() as eng:
            eng.alloc.abort_migration(h.rid)
        h.reserved = False

    def _degrade(self, rid: str) -> None:
        """The re-prefill tier: abort the reservation, release the donor
        slot, hand the request back to the router under its ORIGINAL
        ticket. Never lost (the router re-dispatches or, with no router,
        the donor re-queues it), never duplicated (cancel before commit
        is atomic)."""
        with self._lock:
            h = self._by_rid.pop(rid, None)
            if h is None or h.committed:
                return
            h.cancelled = True
        self._abort_reservation(h)
        with h.donor.server.paused() as eng:
            s = eng.slots[h.slot] if h.slot < len(eng.slots) else None
            if s is not None and s.req.rid == rid:
                eng.release_slot(h.slot, reason="handoff_abort")
        self.degraded += 1
        if self.router is not None:
            self.router.redispatch(h.req)
        else:
            h.donor.server.re_admit(h.req)

    # ---- failover hooks (called by ReplicaRouter.poll) -------------------

    def resolve_dead_donor(self, rid: str):
        """Exactly-once resolution for a request whose PREFILL replica
        died: the decode replica that already owns it (handoff committed:
        repoint, do NOT re-admit), or None after atomically cancelling a
        transfer in flight (the caller re-dispatches; a worker mid-commit
        sees ``cancelled`` and aborts)."""
        with self._lock:
            h = self._by_rid.get(rid)
            if h is None:
                return None
            if h.committed:
                return h.target
            h.cancelled = True
            self._by_rid.pop(rid, None)
        self._abort_reservation(h)
        self.degraded += 1
        return None

    # ---- elastic membership (serving autoscaler) -------------------------

    def attach_prefill(self, rep) -> None:
        """Scale-out: a warm prefill replica joins the donor pool with
        its handoff sink installed, as in ``start()``."""
        with self._lock:
            if rep in self.prefill_pool:
                return
            self.prefill_pool.append(rep)
        rep.server.engine.handoff_sink = self._make_sink(rep)

    def attach_decode(self, rep) -> None:
        """Scale-out: a warm decode replica becomes a handoff target."""
        with self._lock:
            if rep not in self.decode_pool:
                self.decode_pool.append(rep)

    def detach(self, rep) -> None:
        """Scale-in: stop targeting or sourcing ``rep`` for NEW handoffs.
        Handoffs it is donating keep streaming until the caller's drain
        completes; uncommitted handoffs targeting a detached decode
        replica restart elsewhere, as on its death."""
        with self._lock:
            if rep in self.prefill_pool:
                self.prefill_pool.remove(rep)
            was_decode = rep in self.decode_pool
            if was_decode:
                self.decode_pool.remove(rep)
        if was_decode:
            self.on_replica_dead(rep)

    def on_replica_dead(self, rep) -> int:
        """A DECODE replica died: every uncommitted handoff targeting it
        restarts on a surviving decode replica (the donor still holds
        the pages). Returns how many restarts were queued."""
        restart = []
        with self._lock:
            for h in self._by_rid.values():
                if h.target is rep and not h.committed and not h.cancelled:
                    h.target = None
                    h.reserved = False  # dead allocator: nothing to abort
                    restart.append(h.rid)
        for rid in restart:
            self._q.put(("restart", rid, None))
        return len(restart)

    def collapse(self) -> List:
        """Fold the fleet back to unified, the last rung of the ladder,
        taken when either pool has no live member. Transfers in flight
        are cancelled and every occupied prefill slot is released for
        re-prefill (a prefill-role slot holds the prompt's pages only,
        so it cannot decode in place). Returns those orphaned
        ``Request``s for the router to re-dispatch; never takes the
        router lock (the router calls this under it)."""
        with self._lock:
            self._disabled = True
            pending = [h for h in self._by_rid.values() if not h.committed]
            for h in pending:
                h.cancelled = True
            self._by_rid.clear()
        for h in pending:
            if h.target is not None and h.target.alive:
                self._abort_reservation(h)
        orphans = []
        for rep in self.prefill_pool:
            with rep.server.paused() as eng:
                eng.handoff_sink = None
                eng.role = "unified"
                for i, s in enumerate(eng.slots):
                    if s is not None and not s.req.future.done():
                        orphans.append(s.req)
                        eng.release_slot(i, reason="handoff_abort")
        for rep in self.decode_pool:
            with rep.server.paused() as eng:
                eng.role = "unified"
        self.degraded += len(orphans)
        # no join: the worker may wait on the router lock the caller
        # holds; it sees the stop event and exits on its own
        self.stop(join=False)
        return orphans
