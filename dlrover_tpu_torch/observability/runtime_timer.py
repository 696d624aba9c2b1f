"""Continuous runtime kernel timing: a sampled step under the profiler.

Port of ``dlrover_tpu/observability/runtime_timer.py``. Reference:
xpu_timer (atorch/dev/xpu_timer/nvidia/hook.cc), an LD_PRELOAD shim
timing every CUDA kernel launch in production. Here, as in the JAX
version, one training step every ``interval_steps`` runs under the
profiler (``torch.profiler.profile`` with the CPU and, on the card, the
CUDA activity), and the Chrome trace it exports is parsed into a
per-kernel time breakdown (name → total device µs, launches, share).
Sampling costs one profiled step an interval instead of a tax on every
launch, and the breakdown is what ran: every kernel, copy and memset the
step put on the card.

On the card the breakdown is the trace's device events (``DEVICE_CATS``);
a sampled step that shows none is logged as a warning and leaves the
breakdown empty, never filled with host events. On the CPU (the tests)
it is the host's aten ops (``HOST_CATS``), nested ones included, as the
JAX parser sums every complete event of its trace.

The Trainer wires sampling around its step through
``TrainerArgs.profile_interval`` (and forced samples for the watchdog's
captures); ``prometheus_text`` exports the breakdown.
"""

import glob
import gzip
import json
import os
import re
import shutil
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

#: the trace categories of the card's work, and of the host's ops
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)

# python frames and harness markers carry source paths or wrappers;
# everything else of the chosen categories is an executed op
_NOISE = re.compile(r"[$/\\]|^ProfilerStep#|^Thread |^process_|^thread_")


@dataclass
class OpTime:
    name: str
    total_us: float
    count: int
    fraction: float = 0.0


def parse_trace_dir(logdir: str, top_k: int = 0,
                    device: bool = True) -> List[OpTime]:
    """Aggregate the complete ('X') events of the newest Chrome trace
    under ``logdir`` (``*.json`` or ``*.json.gz``) into per-op totals,
    largest first: the device events with ``device``, else the host's
    ops."""
    paths = sorted(
        glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
        + glob.glob(os.path.join(logdir, "**", "*.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not paths:
        return []
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as fh:
        tr = json.load(fh)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    cats = DEVICE_CATS if device else HOST_CATS
    totals: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in cats:
            continue
        name = ev.get("name", "")
        if not name or _NOISE.search(name):
            continue
        cur = totals.setdefault(name, [0.0, 0])
        cur[0] += float(ev.get("dur", 0))
        cur[1] += 1
    out = [OpTime(name=n, total_us=t, count=int(c))
           for n, (t, c) in totals.items()]
    out.sort(key=lambda o: -o.total_us)
    grand = sum(o.total_us for o in out) or 1.0
    for o in out:
        o.fraction = o.total_us / grand
    return out[:top_k] if top_k else out


class RuntimeKernelTimer:
    """Sample-and-parse runtime kernel timing around a step callable."""

    def __init__(self, interval_steps: int = 200, top_k: int = 15,
                 logdir: Optional[str] = None, device="cpu"):
        """``interval_steps=0`` disables the cadence: the timer only
        samples when ``force_next()`` arms it (the watchdog's triggered
        captures). Negative intervals are a config error. ``device``: the
        step's device; on a CUDA one the profiler traces the card."""
        if interval_steps < 0:
            raise ValueError("interval_steps must be >= 0")
        self.interval_steps = interval_steps
        self.top_k = top_k
        self._logdir = logdir
        self.cuda = torch.device(device).type == "cuda"
        self._breakdown: List[OpTime] = []
        self._sampled_at: int = -1
        self._sampled_block_k: int = 1
        self._forced: bool = False

    def should_sample(self, step: int) -> bool:
        if self._forced:
            return True
        return self.interval_steps > 0 and step % self.interval_steps == 0

    def force_next(self) -> None:
        """Arm a one-shot sample: the next ``profiled_call`` profiles
        regardless of the cadence (anomaly-triggered captures)."""
        self._forced = True

    def profiled_call(self, step: int, fn, *args, n_steps: int = 1,
                      **kwargs):
        """Run ``fn``; when the cadence hits, run it under the profiler
        (the card synchronized before the profile closes) and refresh the
        breakdown. ``fn`` runs once either way: a trace that cannot be
        exported or parsed is logged and the breakdown kept as it was.

        ``n_steps``: how many train steps ``fn`` runs (the trainer's
        ``block_k`` block). The breakdown then covers the WHOLE block —
        ``sampled_block_k`` labels it so consumers never mistake a K-step
        capture for one step's budget."""
        if not self.should_sample(step):
            return fn(*args, **kwargs)
        self._forced = False
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            out = fn(*args, **kwargs)
            if self.cuda:
                torch.cuda.synchronize()
        logdir = self._logdir or tempfile.mkdtemp(prefix="dlrover_prof_")
        try:
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(logdir, f"trace_step{step}.json"))
            breakdown = parse_trace_dir(logdir, self.top_k, device=self.cuda)
        except (OSError, ValueError, RuntimeError):
            logger.warning("runtime trace of step %d could not be read",
                           step, exc_info=True)
            return out
        finally:
            if self._logdir is None:
                shutil.rmtree(logdir, ignore_errors=True)
        if self.cuda and not breakdown:
            logger.warning("the profiler recorded no device kernel at step "
                           "%d: the breakdown is empty", step)
        self._breakdown = breakdown
        self._sampled_at = step
        self._sampled_block_k = max(int(n_steps), 1)
        return out

    @property
    def breakdown(self) -> List[OpTime]:
        return list(self._breakdown)

    @property
    def sampled_at(self) -> int:
        return self._sampled_at

    @property
    def sampled_block_k(self) -> int:
        """Steps covered by the current breakdown (1 = a single step)."""
        return self._sampled_block_k

    def summary(self) -> Dict[str, float]:
        return {o.name: o.total_us for o in self._breakdown}

    def prometheus_text(self, prefix: str = "dlrover_tpu_kernel") -> str:
        lines = [f"# TYPE {prefix}_time_us gauge"]
        for o in self._breakdown:
            name = re.sub(r"[^a-zA-Z0-9_.]", "_", o.name)
            lines.append(f'{prefix}_time_us{{op="{name}"}} {o.total_us:.1f}')
        lines.append(f"# sampled_at_step {self._sampled_at}")
        return "\n".join(lines) + "\n"
