"""Resource plans + local heuristic optimizer.

Port of ``dlrover_tpu/master/resource_optimizer.py`` (reference:
dlrover/python/master/resource/: JobResource job.py:71, PSLocalOptimizer
local_optimizer.py:66, BrainResoureOptimizer brain_optimizer.py). Plans
speak in worker (node) counts plus per-role resource hints; the Brain
service (``cluster/brain.py``) is another ``ResourceOptimizer``.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


@dataclass
class ResourcePlan:
    """Target worker count (+ per-node resource hints)."""

    worker_num: Optional[int] = None
    node_resources: Dict[str, Dict] = field(default_factory=dict)

    def empty(self) -> bool:
        return self.worker_num is None and not self.node_resources


class ResourceOptimizer:
    def generate_plan(self, stage: str, stats: Dict) -> ResourcePlan:
        raise NotImplementedError


class LocalHeuristicOptimizer(ResourceOptimizer):
    """Speed-per-worker marginal-utility heuristic.

    Reference analog: AllreduceJobResourceOptimizer (resource/job.py:517) —
    grow while throughput/worker holds, shrink when marginal speedup
    collapses (stragglers, a saturated interconnect).
    """

    def __init__(
        self,
        min_workers: int = 1,
        max_workers: int = 1,
        node_unit: int = 1,
        efficiency_floor: float = 0.7,
    ):
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.node_unit = max(1, node_unit)
        self.efficiency_floor = efficiency_floor
        # history of (worker_num, steps/sec)
        self._speed_history: List[tuple] = []

    def observe(self, worker_num: int, speed: float):
        if speed > 0:
            self._speed_history.append((worker_num, speed))
            self._speed_history = self._speed_history[-64:]

    def generate_plan(self, stage: str, stats: Dict) -> ResourcePlan:
        plan = ResourcePlan()
        workers = stats.get("worker_num", self.min_workers)
        speed = stats.get("speed", 0.0)
        pending = stats.get("pending_nodes", 0)
        self.observe(workers, speed)

        if pending > 0 and workers > self.min_workers:
            # can't place all nodes: fall back to a smaller world
            target = max(
                self.min_workers,
                (workers - pending) // self.node_unit * self.node_unit,
            )
            if target != workers:
                plan.worker_num = target
                logger.info(
                    "scale-in to %d (pending=%d unplaceable)", target, pending
                )
            return plan

        if workers < self.max_workers and self._scaling_efficient():
            plan.worker_num = min(
                self.max_workers, workers + self.node_unit
            )
            logger.info("scale-out to %d workers", plan.worker_num)
        return plan

    def _scaling_efficient(self) -> bool:
        """Did the last scale-up keep per-worker speed above the floor?"""
        by_workers: Dict[int, float] = {}
        for w, s in self._speed_history:
            by_workers[w] = max(by_workers.get(w, 0.0), s)
        if len(by_workers) < 2:
            return True
        sizes = sorted(by_workers)
        w0, w1 = sizes[-2], sizes[-1]
        if by_workers[w0] <= 0:
            return True
        actual = by_workers[w1] / by_workers[w0]
        ideal = w1 / w0
        return actual >= self.efficiency_floor * ideal
