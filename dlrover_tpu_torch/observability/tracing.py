"""Cross-process trace spans: a flight recorder from train step to failover.

Reference: the Chrome trace-event format (``ph``/``ts``/``dur`` in µs)
that Perfetto and ``chrome://tracing`` load directly — the same format
``runtime_timer.parse_perfetto_dir`` already consumes from XLA.

Design constraints this module pins down:

* **Monotonic durations, mergeable timestamps.**  Each tracer anchors
  ``time.monotonic()`` to the wall clock once at construction
  (``ts_us = (wall0 + (monotonic() - mono0)) * 1e6``), so span
  durations are immune to NTP steps while events from *different
  processes on the same machine* still land on one shared timeline.
* **Cross-process correlation.**  Every event carries the job/run/
  restart/rendezvous-round identity from the ``DLROVER_TPU_*``
  environment (injected by the agent into workers), so one merged file
  interleaves worker, agent and master spans of the same failover.
* **Zero-cost when off.**  ``get_tracer()`` returns a module-pinned
  ``NullTracer`` unless tracing was configured (explicitly or via
  ``DLROVER_TPU_TRACE_DIR``); its ``span()`` hands back a shared
  no-op span object, so a disabled hot path allocates nothing.

The port's copy of the tracer in ``dlrover_tpu/observability/tracing.py``
(the merge helpers stay there): both packages read the same environment
and write the same event format, so a merged trace interleaves them.

Producers stream one JSON event per line into
``$DLROVER_TPU_TRACE_DIR/trace-{role}-{pid}.jsonl`` (append-only, one
file per process — no cross-process locking); the JAX package's
``merge_trace_dir`` zips the per-process files into one timeline.
"""

import io
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

_RING_CAPACITY = 4096


def _correlation_from_env() -> Dict[str, object]:
    """Identity fields stamped onto every event of this process."""
    env = os.environ
    args: Dict[str, object] = {}
    run_id = env.get(GraftEnv.RUN_ID, "")
    if run_id:
        args["run"] = run_id
    job = env.get(GraftEnv.JOB_NAME, "")
    if job:
        args["job"] = job
    for key, envname in (
        ("node", GraftEnv.NODE_ID),
        ("restart", GraftEnv.RESTART_COUNT),
        ("rdzv_round", GraftEnv.RDZV_ROUND),
    ):
        val = env.get(envname, "")
        if val:
            try:
                args[key] = int(val)
            except ValueError:
                args[key] = val
    return args


class Span:
    """One open interval; close with ``end()`` or use as a context manager."""

    __slots__ = ("name", "args", "_tracer", "_t0_mono", "_ts_us", "dur_us")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0_mono = time.monotonic()
        self._ts_us = tracer._now_us()
        self.dur_us = -1.0  # open

    def end(self, **extra) -> float:
        """Close the span; returns the duration in seconds."""
        if self.dur_us >= 0:  # double-end is a no-op
            return self.dur_us / 1e6
        self.dur_us = (time.monotonic() - self._t0_mono) * 1e6
        if extra:
            self.args.update(extra)
        self._tracer._emit_complete(self)
        return self.dur_us / 1e6

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.end()
        return False


class _NullSpan:
    """Shared, stateless stand-in handed out by ``NullTracer``."""

    __slots__ = ()
    name = ""
    dur_us = 0.0

    @property
    def args(self) -> Dict:
        # fresh dict per access: writes from callers annotating a live
        # span (``sp.args["k"] = v``) are silently discarded instead of
        # accumulating on a shared class attribute
        return {}

    def end(self, **extra) -> float:
        return 0.0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span recorder with Chrome-trace export.

    Events land in a bounded ring buffer (so a long run cannot grow
    memory without bound) and — when a ``trace_dir`` is set — are also
    streamed line-by-line to this process's JSONL file, which survives
    the process being SIGKILLed mid-failover (the exact moment the
    flight recorder exists for).
    """

    enabled = True

    def __init__(
        self,
        role: str = "proc",
        trace_dir: Optional[str] = None,
        capacity: int = _RING_CAPACITY,
    ):
        self.role = role
        self.pid = os.getpid()
        self._wall0 = time.time()
        self._mono0 = time.monotonic()
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._common = _correlation_from_env()
        self._common["role"] = role
        self._file: Optional[io.TextIOWrapper] = None
        if trace_dir:
            try:
                os.makedirs(trace_dir, exist_ok=True)
                path = os.path.join(
                    trace_dir, f"trace-{role}-{self.pid}.jsonl"
                )
                self._file = open(path, "a", buffering=1)
            except OSError as e:
                logger.warning("tracing: cannot open trace file: %s", e)

    # ---- clock ----------------------------------------------------------

    def _now_us(self) -> float:
        """Wall-anchored monotonic µs: comparable across processes,
        immune to wall-clock steps within one process."""
        return (self._wall0 + (time.monotonic() - self._mono0)) * 1e6

    # ---- span API -------------------------------------------------------

    def span(self, name: str, **args) -> Span:
        """Open a span; close via ``with`` or explicit ``end()``."""
        return Span(self, name, args)

    def begin(self, name: str, **args) -> Span:
        """Explicit-lifetime alias of :meth:`span`."""
        return Span(self, name, args)

    def end(self, span: Span, **extra) -> float:
        return span.end(**extra)

    def complete_span(self, name: str, t0_mono: float, **args) -> float:
        """Emit a complete ("X") event back-dated to a monotonic start.

        For intervals whose start was stamped before a span could be
        opened — e.g. queue wait, measured from ``Request.submit_t``
        (taken on the submitting user thread) to admission (on the
        engine loop thread). Returns the duration in seconds."""
        now = time.monotonic()
        dur_s = max(0.0, now - t0_mono)
        self._record(
            {
                "name": name,
                "ph": "X",
                "ts": self._now_us() - dur_s * 1e6,
                "dur": dur_s * 1e6,
                "args": args,
            }
        )
        return dur_s

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event."""
        self._record(
            {
                "name": name,
                "ph": "i",
                "ts": self._now_us(),
                "s": "p",
                "args": args,
            }
        )

    def counter(self, name: str, **values) -> None:
        """A Chrome counter event (stacked series in the trace viewer)."""
        self._record(
            {"name": name, "ph": "C", "ts": self._now_us(), "args": values}
        )

    # ---- emission -------------------------------------------------------

    def _emit_complete(self, span: Span) -> None:
        self._record(
            {
                "name": span.name,
                "ph": "X",
                "ts": span._ts_us,
                "dur": span.dur_us,
                "args": span.args,
            }
        )

    def _record(self, ev: Dict) -> None:
        ev["pid"] = self.pid
        ev["tid"] = threading.get_ident() & 0x7FFFFFFF
        if self._common:
            merged = dict(self._common)
            merged.update(ev.get("args") or {})
            ev["args"] = merged
        with self._lock:
            self._events.append(ev)
            if self._file is not None:
                try:
                    self._file.write(json.dumps(ev) + "\n")
                except (OSError, ValueError):
                    self._file = None  # fd gone (shutdown); keep the ring

    # ---- export ---------------------------------------------------------

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict:
        """The in-memory ring as a Chrome trace-event JSON object."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                finally:
                    self._file = None


class NullTracer:
    """Disabled tracer: every call is a pinned no-op."""

    enabled = False
    role = ""

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    begin = span

    def end(self, span, **extra) -> float:
        return 0.0

    def complete_span(self, name: str, t0_mono: float, **args) -> float:
        return 0.0

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, **values) -> None:
        pass

    def events(self) -> List[Dict]:
        return []

    def chrome_trace(self) -> Dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def close(self) -> None:
        pass


_NULL_TRACER = NullTracer()
_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def configure_tracer(
    role: str, trace_dir: Optional[str] = None, force: bool = False
) -> Tracer:
    """Install the process tracer (idempotent unless ``force``).

    ``trace_dir=None`` falls back to ``$DLROVER_TPU_TRACE_DIR``; with
    neither set the tracer still records to its in-memory ring (useful
    in tests and for on-demand export).
    """
    global _tracer
    with _tracer_lock:
        if _tracer is not None and not force:
            return _tracer
        if _tracer is not None:
            _tracer.close()
        trace_dir = trace_dir or os.getenv(GraftEnv.TRACE_DIR) or None
        _tracer = Tracer(role=role, trace_dir=trace_dir)
        return _tracer


def get_tracer():
    """The process tracer, or the pinned ``NullTracer`` when tracing is
    off.  Auto-enables when ``DLROVER_TPU_TRACE_DIR`` is set (role from
    ``DLROVER_TPU_TRACE_ROLE``), so workers inherit tracing from the
    agent's environment injection without any code-side wiring."""
    if _tracer is not None:
        return _tracer
    trace_dir = os.getenv(GraftEnv.TRACE_DIR)
    if trace_dir:
        return configure_tracer(
            os.getenv(GraftEnv.TRACE_ROLE, "proc"), trace_dir
        )
    return _NULL_TRACER


def reset_tracer() -> None:
    """Drop the installed tracer (tests)."""
    global _tracer
    with _tracer_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = None
