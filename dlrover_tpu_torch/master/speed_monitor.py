"""Training speed monitor (reference: monitor/speed_monitor.py:43).

Port of ``dlrover_tpu/master/speed_monitor.py``, unchanged.

Collects global-step reports and derives steps/sec; provides the
straggler baseline and the goodput numerator (steps while healthy).

Interval arithmetic runs on the master's ``time.monotonic()`` arrival
clock — worker-supplied wall timestamps cross NTP-skewed hosts and a
wall-clock step would otherwise produce negative speeds or inflated
goodput.  The worker wall timestamp is still retained per watermark for
display/correlation, it just never enters a subtraction.

Per-worker step watermarks track each reporting node's frontier; a node
whose step rate falls behind the median by ``DefaultValues
.STRAGGLER_RATIO`` is flagged onto the telemetry bus as a
:class:`~dlrover_tpu_torch.observability.telemetry.StragglerRecord` (edge-
triggered — one record per transition into straggling, not per report).
"""

import statistics
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from dlrover_tpu_torch.common.constants import DefaultValues
from dlrover_tpu_torch.observability import telemetry


class SpeedMonitor:
    def __init__(
        self,
        window: int = DefaultValues.SPEED_MONITOR_WINDOW,
        straggler_ratio: float = DefaultValues.STRAGGLER_RATIO,
    ):
        self._lock = threading.Lock()
        self._records: Deque[Tuple[float, int]] = deque(maxlen=window)
        self._global_step = 0
        self._worker_num = 0
        self._init_step = 0
        self._first_report: Optional[float] = None  # monotonic
        self._straggler_ratio = straggler_ratio
        # node_id → (step, mono_arrival, wall_ts, step_rate)
        self._watermarks: Dict[int, Tuple[int, float, float, float]] = {}
        self._flagged: set = set()
        self._hub = None

    def attach_hub(self, hub) -> None:
        """Publish straggler flags onto this telemetry hub."""
        self._hub = hub

    def set_worker_num(self, n: int):
        with self._lock:
            self._worker_num = n

    def collect_global_step(
        self,
        step: int,
        timestamp: float = 0.0,
        node_id: int = -1,
        now: Optional[float] = None,
    ):
        """Ingest one step report.

        ``timestamp`` is the worker's wall clock (kept on the watermark
        only); ``now`` is the master-side monotonic arrival time,
        injectable for tests.
        """
        now = time.monotonic() if now is None else now
        flag = None
        with self._lock:
            if self._first_report is None:
                self._first_report = now
                self._init_step = step
            self._global_step = step
            self._records.append((now, step))
            if node_id >= 0:
                flag = self._update_watermark(node_id, step, now, timestamp)
        if flag is not None and self._hub is not None and self._hub.enabled:
            self._hub.publish(flag)

    def _update_watermark(self, node_id, step, now, wall_ts):
        """Lock held.  Returns a StragglerRecord on a fresh flag."""
        prev = self._watermarks.get(node_id)
        rate = prev[3] if prev else 0.0
        if prev and now > prev[1] and step > prev[0]:
            rate = (step - prev[0]) / (now - prev[1])
        self._watermarks[node_id] = (step, now, wall_ts, rate)
        rates = [w[3] for w in self._watermarks.values() if w[3] > 0]
        if len(rates) < 2 or rate <= 0:
            return None
        med = statistics.median(rates)
        if med > 0 and med / rate >= self._straggler_ratio:
            if node_id not in self._flagged:
                self._flagged.add(node_id)
                max_step = max(w[0] for w in self._watermarks.values())
                return telemetry.StragglerRecord(
                    node_id=node_id,
                    step=step,
                    max_step=max_step,
                    lag_steps=max_step - step,
                    ratio=med / rate,
                )
        else:
            self._flagged.discard(node_id)
        return None

    def worker_watermarks(self) -> Dict[int, Dict]:
        """Per-node step frontier: {node: {step, age_s, wall_ts, rate}}."""
        now = time.monotonic()
        with self._lock:
            return {
                n: {
                    "step": w[0],
                    "age_s": max(0.0, now - w[1]),
                    "wall_ts": w[2],
                    "rate": w[3],
                }
                for n, w in self._watermarks.items()
            }

    def stragglers(self) -> set:
        with self._lock:
            return set(self._flagged)

    def drop_node(self, node_id: int):
        """A node left: its stale watermark must not skew the median."""
        with self._lock:
            self._watermarks.pop(node_id, None)
            self._flagged.discard(node_id)

    @property
    def global_step(self) -> int:
        with self._lock:
            return self._global_step

    @property
    def running_speed(self) -> float:
        """steps/sec over the sliding window."""
        with self._lock:
            if len(self._records) < 2:
                return 0.0
            (t0, s0), (t1, s1) = self._records[0], self._records[-1]
            if t1 <= t0:
                return 0.0
            return (s1 - s0) / (t1 - t0)

    def all_time_speed(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._first_report is None:
                return 0.0
            dt = now - self._first_report
            return (self._global_step - self._init_step) / dt if dt > 0 else 0.0

    def reset_running_speed(self):
        with self._lock:
            self._records.clear()
