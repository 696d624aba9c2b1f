"""Threaded generation server: one engine, one scheduler, one loop.

Port of ``dlrover_tpu/serving/server.py``'s ``GenerationServer``.
``GenerationServer`` owns a ``Scheduler`` (request intake, latency
accounting) and a ``ServingEngine`` (continuous batching over the paged
KV cache) and drives the engine from a background thread. User threads
call ``submit`` (non-blocking; the returned ``Request`` carries a
``concurrent.futures.Future``) or ``generate`` (blocking convenience);
the loop sleeps briefly when fully idle instead of spinning.

``kill`` stops the loop abruptly WITHOUT resolving in-flight futures:
the eviction drill. A replica dying mid-stream leaves its requests
dangling until ``ReplicaRouter.poll`` migrates their KV pages to a
survivor, or re-admits them where migration is unavailable
(``serving/replica.py``, ``serving/migration.py``).

``paused()`` is the concurrency contract for anything that must touch
the engine's pools, allocator or slots from another thread (a migrator
reserving pages or importing a slot): the loop parks at a step
boundary and the caller gets exclusive access.
"""

import contextlib
import threading
import time

from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.serving.engine import ServingEngine
from dlrover_tpu_torch.serving.scheduler import (
    AdmissionError, Request, SamplingParams, Scheduler,
)


class GenerationServer:
    """Single-replica serving front end (threaded loop around the engine).

    ``model`` is a ``models.decoder.Decoder``; ``device`` (default
    ``"cuda"``, raising without a card) and the other engine options
    pass through ``engine_kw`` to ``ServingEngine``. ``watchdog`` (an
    ``observability.watchdog.ServingWatchdog``) observes every
    published record; its capture snapshot defaults to the engine's
    ``observability_snapshot``."""

    def __init__(
        self,
        model,
        cfg,
        *,
        hub=None,
        replica: str = "replica-0",
        max_queue: int = 256,
        publish_every: float = 0.5,
        idle_sleep: float = 0.002,
        watchdog=None,
        **engine_kw,
    ):
        self.replica = replica
        self.scheduler = Scheduler(
            max_queue=max_queue, hub=hub, replica=replica
        )
        self.engine = ServingEngine(model, cfg, self.scheduler, **engine_kw)
        self.watchdog = watchdog
        if watchdog is not None and watchdog.snapshot_fn is None:
            watchdog.snapshot_fn = self.engine.observability_snapshot
        self.publish_every = publish_every
        self.idle_sleep = idle_sleep
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._pause_lock = threading.Lock()   # serializes paused() users
        self._pause_req = threading.Event()   # ask the loop to park
        self._pause_ack = threading.Event()   # loop parked at a boundary
        self.error: BaseException | None = None  # what killed the loop

    # ---- lifecycle -------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "GenerationServer":
        if self.alive:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"serving-{self.replica}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful: finish nothing extra, just stop the loop and join."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def kill(self) -> None:
        """Abrupt stop standing in for a host eviction: the loop halts at
        the next step boundary and in-flight futures stay UNRESOLVED for
        the router's failover to pick up."""
        self.stop()

    @contextlib.contextmanager
    def paused(self, timeout: float = 30.0):
        """Exclusive engine access at a step boundary: parks the loop
        thread, yields the engine, then resumes it. A pass-through when
        the loop is not running (a killed replica: the migration donor
        case)."""
        with self._pause_lock:
            if not self.alive:
                yield self.engine
                return
            self._pause_ack.clear()
            self._pause_req.set()
            self._pause_ack.wait(timeout)
            try:
                yield self.engine
            finally:
                self._pause_req.clear()

    def begin_drain(self) -> None:
        """Planned drain: stop admitting queued work so in-flight slots
        finish."""
        self.engine.draining = True

    def _loop(self) -> None:
        last_pub = time.monotonic()
        try:
            while not self._stop_evt.is_set():
                if self._pause_req.is_set():
                    # re-ack every tick: a second paused() user can clear
                    # the ack and re-raise the request before this thread
                    # observes the gap between them
                    while (self._pause_req.is_set()
                           and not self._stop_evt.is_set()):
                        self._pause_ack.set()
                        time.sleep(0.001)
                    continue
                worked = self.engine.step()
                now = time.monotonic()
                if now - last_pub >= self.publish_every:
                    self._publish()
                    last_pub = now
                if not worked:
                    self._stop_evt.wait(self.idle_sleep)
        except BaseException as exc:
            # a failed step (a kernel fault, a build error) must not leave
            # callers waiting on futures forever: fail every request the
            # engine holds or has queued, then re-raise in this thread
            self.error = exc
            self._fail_all(exc)
            raise
        # final snapshot so short-lived servers still leave telemetry
        self._publish()

    def _fail_all(self, exc: BaseException) -> None:
        err = RuntimeError(f"serving loop of {self.replica} died: {exc!r}")
        for s in self.engine.slots:
            if s is not None:
                self.scheduler.fail(s.req, err)
        while True:
            req = self.scheduler.pop_next()
            if req is None:
                break
            self.scheduler.fail(req, err)

    def _publish(self) -> None:
        stats = self.engine.stats()
        rec = self.scheduler.publish(stats)
        if self.watchdog is not None:
            self.watchdog.observe(rec)
        tr = get_tracer()
        if tr.enabled:
            tr.counter(
                f"serving.occupancy.{self.replica}",
                active_slots=stats["active_slots"],
                queue_depth=rec.queue_depth,
                free_pages=stats["free_pages"],
            )

    # ---- intake ----------------------------------------------------------

    def submit(
        self, prompt, max_new_tokens: int, eos_id=None, priority: int = 0,
        sampling: SamplingParams | None = None,
        deadline_s: float | None = None,
    ) -> Request:
        if len(prompt) + max_new_tokens > self.engine.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                f"exceeds slot capacity {self.engine.max_len}"
            )
        return self.scheduler.submit(
            prompt, max_new_tokens, eos_id=eos_id, priority=priority,
            sampling=sampling, deadline_s=deadline_s,
        )

    @property
    def role(self) -> str:
        """This replica's pool in a disaggregated fleet: ``"prefill"``,
        ``"decode"`` or ``"unified"``."""
        return self.engine.role

    def re_admit(self, req: Request) -> None:
        """Re-prefill failover intake, the migration ladder's fallback:
        requeue another replica's in-flight request under its original
        ticket; generation restarts from the prompt and, the draws being
        keyed on seed and position, repeats the original stream.

        Refused on a decode-role replica: a raw re-admission would run a
        full prefill on the decode path, the interference the split
        removes. Role-aware callers (the router) route the ticket
        through the prefill pool instead."""
        if self.engine.role == "decode":
            raise AdmissionError(
                f"decode-role replica {self.replica} cannot re-prefill "
                f"{req.rid}: route it through the prefill pool"
            )
        self.scheduler.re_admit(req)

    def generate(
        self, prompt, max_new_tokens: int, eos_id=None,
        timeout: float = 120.0, sampling: SamplingParams | None = None,
    ):
        """Blocking convenience: submit and wait for the full sequence."""
        return self.submit(
            prompt, max_new_tokens, eos_id=eos_id, sampling=sampling
        ).future.result(timeout)
