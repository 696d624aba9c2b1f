"""Trainer callback protocol + stock callbacks.

A copy of ``dlrover_tpu/train/callbacks.py``: callbacks observe
(step, metrics) on the host and steer the loop through a mutable
``TrainerControl``; the step itself is never touched, so a callback
cannot slow the device path. Metrics reach a callback as host floats.
"""

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


@dataclass
class TrainerControl:
    """Flow flags a callback may set; the loop reads them every step."""

    should_stop: bool = False
    should_save: bool = False   # force a checkpoint after this step
    should_eval: bool = False   # force an eval after this step
    should_log: bool = False    # force a log flush after this step

    def reset_step_flags(self):
        self.should_save = False
        self.should_eval = False
        self.should_log = False


class Callback:
    """Base callback: override any subset of hooks.

    Hooks receive the live Trainer (``trainer.state``, ``trainer.args``…)
    and the shared TrainerControl. ``metrics``/``logs`` are plain host
    floats — the loop materializes them before dispatch.
    """

    def on_train_begin(self, trainer, control: TrainerControl):
        pass

    def on_step_end(
        self, trainer, step: int, metrics: Dict[str, float],
        control: TrainerControl,
    ):
        pass

    def on_log(
        self, trainer, step: int, logs: Dict[str, Any],
        control: TrainerControl,
    ):
        pass

    def on_eval(
        self, trainer, step: int, eval_metrics: Dict[str, float],
        control: TrainerControl,
    ):
        pass

    def on_save(self, trainer, step: int, control: TrainerControl):
        pass

    def on_train_end(self, trainer, control: TrainerControl):
        pass


class CallbackList:
    """Dispatch helper; isolates the loop from individual callbacks."""

    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks: List[Callback] = list(callbacks or [])

    def add(self, cb: Callback):
        self.callbacks.append(cb)

    def fire(self, hook: str, *args, **kwargs):
        for cb in self.callbacks:
            getattr(cb, hook)(*args, **kwargs)


# ---------------------------------------------------------------------------
# stock callbacks
# ---------------------------------------------------------------------------


class LRLoggingCallback(Callback):
    """Adds the current learning rate to every log record.

    Pass the schedule explicitly (e.g. ``train.optimizer.warmup_cosine(...)``,
    the one handed to the optimizer). Without one, the callback probes
    ``trainer.optimizer.schedule`` for optimizer objects that expose the
    attribute, else logs nothing.
    """

    def __init__(self, schedule=None):
        self.schedule = schedule

    def on_log(self, trainer, step, logs, control):
        sched = self.schedule
        if sched is None:
            sched = getattr(trainer.optimizer, "schedule", None)
        if callable(sched):
            logs["learning_rate"] = float(sched(step))


class LossSpikeCallback(Callback):
    """Bridges observability/loss_spike.py into the callback protocol:
    records every loss, dumps a window around detected spikes."""

    def __init__(self, detector):
        self.detector = detector

    def on_step_end(self, trainer, step, metrics, control):
        if "loss" not in metrics:
            return
        # the detector itself publishes the NumericEvent (with culprit
        # sample ids when it has them) — no hub duplication here
        self.detector.update(step, metrics["loss"])


class EarlyStoppingCallback(Callback):
    """Stop when the watched eval metric fails to improve.

    Reference parity: HF/atorch EarlyStoppingCallback semantics —
    ``patience`` evals without ``min_delta`` improvement stops training.
    """

    def __init__(
        self, metric: str = "loss", patience: int = 3,
        min_delta: float = 0.0, mode: str = "min",
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.metric = metric
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.bad_evals = 0

    def on_eval(self, trainer, step, eval_metrics, control):
        val = eval_metrics.get(self.metric)
        if val is None:
            return
        improved = (
            val < self.best - self.min_delta
            if self.mode == "min"
            else val > self.best + self.min_delta
        )
        if improved:
            self.best = val
            self.bad_evals = 0
            return
        self.bad_evals += 1
        if self.bad_evals >= self.patience:
            logger.info(
                "early stop at step %d: %s did not improve for %d evals "
                "(best %.6f)", step, self.metric, self.bad_evals, self.best,
            )
            control.should_stop = True


class JsonlLoggingCallback(Callback):
    """Append every log/eval record to ``output_dir/train_log.jsonl`` —
    the file-based analog of the reference's tensorboard/wandb
    integrations (kept dependency-free; each line is one record)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None

    def _file(self, trainer):
        if self._fh is None:
            path = self.path or os.path.join(
                trainer.args.output_dir, "train_log.jsonl"
            )
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")
        return self._fh

    def _write(self, trainer, record):
        fh = self._file(trainer)
        fh.write(json.dumps(record) + "\n")
        fh.flush()

    def on_log(self, trainer, step, logs, control):
        self._write(
            trainer, {"kind": "train", "step": step, "time": time.time(),
                      **logs},
        )

    def on_eval(self, trainer, step, eval_metrics, control):
        self._write(
            trainer, {"kind": "eval", "step": step, "time": time.time(),
                      **eval_metrics},
        )

    def on_train_end(self, trainer, control):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
