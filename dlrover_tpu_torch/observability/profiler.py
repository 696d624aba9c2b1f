"""Step timing: host wall seconds and, on the card, device milliseconds.

Port of ``StepTimer`` from ``dlrover_tpu/observability/profiler.py``.
The JAX timer reads the host clock after ``block_until_ready``; here
each timed span also records a CUDA event at its start and its end on
the current stream, so a step's device time is read beside its wall
time without an extra synchronization: ``stop`` only records, and
``record`` reads both once the caller has waited for the step's outputs
anyway (the loss read, or a block's metrics drain). On the CPU there is
no device time (``device_ms`` is None).
"""

import time
from collections import deque
from typing import Deque, Optional

import torch


class Timing:
    """One timed span of ``n_steps`` steps, between ``stop`` and
    ``record``."""

    __slots__ = ("t0", "start", "end", "n_steps")

    def __init__(self, t0, start, end, n_steps):
        self.t0, self.start, self.end, self.n_steps = t0, start, end, n_steps


class StepTimer:
    """Ring buffers of per-step wall seconds and device ms."""

    def __init__(self, device: torch.device, window: int = 256):
        self.cuda = torch.device(device).type == "cuda"
        self._times: Deque[float] = deque(maxlen=window)
        self._device_ms: Deque[float] = deque(maxlen=window)
        self._t0: Optional[float] = None
        self._start = None

    def start(self) -> None:
        self._t0 = time.perf_counter()
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()

    def stop(self, n_steps: int = 1) -> Timing:
        """Close the span the last ``start`` opened (no wait)."""
        end = None
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        return Timing(self._t0, self._start, end, max(int(n_steps), 1))

    def record(self, timing: Timing) -> None:
        """Ingest a span whose work the caller has waited for: its wall
        time (from ``start`` to now) and device time, each per step."""
        n = timing.n_steps
        wall = (time.perf_counter() - timing.t0) / n
        dev = None
        if timing.end is not None:
            timing.end.synchronize()
            dev = timing.start.elapsed_time(timing.end) / n
        for _ in range(n):
            self._times.append(wall)
            if dev is not None:
                self._device_ms.append(dev)

    @property
    def last_s(self) -> float:
        return self._times[-1] if self._times else 0.0

    @property
    def last_device_ms(self) -> Optional[float]:
        return self._device_ms[-1] if self._device_ms else None
