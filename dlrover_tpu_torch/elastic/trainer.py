"""ElasticTrainer: fixed global batch across world-size changes.

Reference: trainer/torch/elastic/trainer.py:48 (gradient-accumulation
elasticity: when the world shrinks from 8 to 6 hosts, each remaining host
accumulates more microbatches so the *global* batch — and therefore the
learning-rate schedule — is unchanged).

Port of ``dlrover_tpu/elastic/trainer.py``: a thin coordinator that
derives (micro_batch, grad_accum) from the live data-parallel size and
rebuilds the step on a membership change, and applies a Brain tuning
revision at a step boundary (``apply_tuning``: a new micro-batch
re-derives the accumulation, any versioned revision rebuilds the step;
the optimizer state is untouched).
"""

import math
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.train.distributed import process_count

logger = get_logger(__name__)


class ElasticTrainer:
    def __init__(
        self,
        global_batch_size: int,
        micro_batch_size: int,
        build_step: Callable[[int], Callable],
        data_replicas_fn: Optional[Callable[[], int]] = None,
    ):
        """``build_step(grad_accum) -> step_fn``;
        ``data_replicas_fn() -> number of data-parallel batch shards``."""
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size
        self._build_step = build_step
        self._data_replicas_fn = data_replicas_fn or process_count
        self._replicas = 0
        self._step_fn: Optional[Callable] = None
        self.grad_accum = 1
        self._refresh()

    def _refresh(self):
        replicas = max(1, self._data_replicas_fn())
        if replicas == self._replicas and self._step_fn is not None:
            return
        replan_span = get_tracer().span(
            "failover.mesh_replan",
            replicas_from=self._replicas,
            replicas_to=replicas,
        )
        per_step = self.micro_batch_size * replicas
        self.grad_accum = max(
            1, math.ceil(self.global_batch_size / per_step)
        )
        effective = self.grad_accum * per_step
        if effective != self.global_batch_size:
            logger.warning(
                "global batch %d not divisible by micro %d × replicas %d; "
                "using %d",
                self.global_batch_size,
                self.micro_batch_size,
                replicas,
                effective,
            )
        logger.info(
            "elastic trainer: replicas=%d grad_accum=%d (global batch %d)",
            replicas,
            self.grad_accum,
            effective,
        )
        self._replicas = replicas
        self._step_fn = self._build_step(self.grad_accum)
        seconds = replan_span.end(grad_accum=self.grad_accum)
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(
                telemetry.ElasticEvent(
                    kind="mesh_replan",
                    seconds=seconds,
                    detail=f"replicas={replicas} accum={self.grad_accum}",
                )
            )
            if effective != self.global_batch_size:
                # the LR schedule assumes global_batch_size; any drift in
                # the effective batch silently reshapes the schedule, so
                # surface it as a metric, not just a one-shot warning
                hub.publish(
                    telemetry.NumericEvent(
                        kind="effective_batch_drift",
                        value=float(effective - self.global_batch_size),
                        detail=(
                            f"global={self.global_batch_size} "
                            f"micro={self.micro_batch_size} "
                            f"replicas={replicas} accum={self.grad_accum} "
                            f"effective={effective}"
                        ),
                    )
                )

    def on_membership_change(self):
        """Re-derive accumulation after a re-mesh; rebuilds the step."""
        self._step_fn = None
        self._refresh()

    @property
    def local_batch_size(self) -> int:
        """Per-process batch to feed each call (micro × accum)."""
        return self.micro_batch_size * self.grad_accum

    def apply_tuning(self, plan) -> bool:
        """Apply a Brain tuning revision at a step boundary.

        ``plan`` is a ``cluster/brain.py`` TuningPlan (or its dict form
        from the ``ParalConfigTuner`` document). A positive
        ``batch_size`` re-derives accumulation at the new micro-batch;
        any versioned revision forces a step rebuild, so builder-side
        knobs already folded in with ``cluster.brain.apply_revision``
        (remat, the comm bucket, the wire dtypes) land in the next step.
        Optimizer state is untouched: a retune is a rebuild, never a
        restart. A remat policy the port cannot run raises (ROADMAP
        A21) before anything changes. Returns True when a rebuild ran.
        """
        from dlrover_tpu_torch.cluster.brain import check_remat

        def knob(name, default=0):
            if isinstance(plan, dict):
                return plan.get(name, default)
            return getattr(plan, name, default)

        check_remat(knob("remat", "") or "")
        version = int(knob("version") or 0)
        batch = int(knob("batch_size") or 0)
        if batch > 0 and batch != self.micro_batch_size:
            self.micro_batch_size = batch
        elif not version:
            return False
        span = get_tracer().span("brain.tuning_replan", version=version)
        replicas = max(1, self._data_replicas_fn())
        per_step = self.micro_batch_size * replicas
        self.grad_accum = max(
            1, math.ceil(self.global_batch_size / per_step)
        )
        self._replicas = replicas
        self._step_fn = self._build_step(self.grad_accum)
        seconds = span.end(grad_accum=self.grad_accum)
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(
                telemetry.ElasticEvent(
                    kind="tuning_replan",
                    seconds=seconds,
                    detail=(
                        f"v{version} micro={self.micro_batch_size} "
                        f"accum={self.grad_accum}"
                    ),
                )
            )
        return True

    def step(self, state, batch):
        self._refresh()
        return self._step_fn(state, batch)
