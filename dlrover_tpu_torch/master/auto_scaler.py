"""JobAutoScaler: the master's periodic auto-scaling loop.

Port of ``dlrover_tpu/master/auto_scaler.py`` (reference:
dlrover/python/master/node/job_auto_scaler.py:40,
AllreduceTrainingAutoScaler._periodic_adjust_worker:288). Each period
it hands the job's worker count, its running speed and its unplaceable
nodes to the resource optimizer (``LocalHeuristicOptimizer``, or the
Brain in cluster mode), clamps the plan's target to the job's declared
``[min, max]``, moves the node manager's worker count, widens the
rendezvous to the new world and pushes a ``ScalePlan`` to the platform's
scaler; a plan's sparse-tier hints go to ``ElasticPsService`` (weights)
and to the platform's PS hook (counts). After a scale event, nodes still
booting are not counted unplaceable for a grace window.

The speed goes to the optimizer under both names its optimizers read:
``speed`` (``LocalHeuristicOptimizer``) and ``steps_per_sec`` (the
Brain's running-job algorithm). The JAX loop sends only ``speed``, so
its Brain never plans a running job's worker count (ROADMAP C).
"""

import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.constants import DefaultValues
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.node_manager import JobManager, ScalePlan, Scaler
from dlrover_tpu_torch.master.resource_optimizer import (
    LocalHeuristicOptimizer,
    ResourceOptimizer,
)
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

logger = get_logger(__name__)


class JobAutoScaler:
    def __init__(
        self,
        job_manager: JobManager,
        speed_monitor: SpeedMonitor,
        scaler: Scaler,
        rdzv_managers=None,
        optimizer: Optional[ResourceOptimizer] = None,
        interval_s: float = DefaultValues.AUTOSCALE_INTERVAL_S,
        min_workers: int = 1,
        max_workers: int = 1,
        node_unit: int = 1,
        ps_service=None,
        ps_scale_fn=None,
    ):
        self.job_manager = job_manager
        self.speed_monitor = speed_monitor
        self.scaler = scaler
        self.rdzv_managers = rdzv_managers or {}
        # sparse-tier consumers of the Brain's ps hints: a weight
        # rebalance goes to the version service, a count change to the
        # platform hook (fn(target_num))
        self.ps_service = ps_service
        self.ps_scale_fn = ps_scale_fn
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.optimizer = optimizer or LocalHeuristicOptimizer(
            min_workers=min_workers,
            max_workers=max_workers,
            node_unit=node_unit,
        )
        self.interval_s = interval_s
        # grace before treating unregistered nodes as unplaceable: newly
        # requested hosts take a while to schedule and join
        self.pending_grace_s = DefaultValues.SECONDS_TO_WAIT_PENDING_POD
        self._last_scale_time = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="auto-scaler", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.adjust_once()
            except Exception:  # noqa: BLE001
                logger.exception("auto-scale iteration failed")

    def adjust_once(self):
        running = self.job_manager.running_nodes()
        pending = max(0, self.job_manager.worker_num - len(running))
        # inside the grace window after a scale event, booting nodes are
        # not "unplaceable": don't flap back down
        in_grace = (
            time.time() - self._last_scale_time < self.pending_grace_s
        )
        speed = self.speed_monitor.running_speed
        stats = {
            "worker_num": self.job_manager.worker_num,
            "speed": speed,
            "steps_per_sec": speed,
            "pending_nodes": 0 if in_grace else pending,
        }
        if in_grace and pending > 0:
            return  # wait for the last scale event to settle
        plan = self.optimizer.generate_plan("running", stats)
        if plan.empty():
            return
        self.execute_plan(plan)

    def execute_plan(self, plan):
        # sparse-tier hints execute regardless of the worker target: a
        # hot-shard rebalance installs HRW weights and bumps the sparse
        # cluster version so workers re-partition with bounded migration
        ps_hints = plan.node_resources.get("ps", {})
        if self.ps_service is not None and "weights" in ps_hints:
            self.ps_service.set_weights(ps_hints["weights"])
        if "num" in ps_hints:
            if self.ps_scale_fn is not None:
                self.ps_scale_fn(int(ps_hints["num"]))
            else:
                logger.warning(
                    "plan requests %d sparse hosts but no ps_scale_fn "
                    "is bound — sparse tier not scaled",
                    ps_hints["num"],
                )

        target = plan.worker_num
        if target is None:
            return
        # clamp to the JOB's declared elastic range: a cluster-shared
        # optimizer (BrainClient) was not built with this job's min/max
        # the way the local heuristic is
        clamped = max(self.min_workers, min(self.max_workers, target))
        if clamped != target:
            logger.info(
                "auto-scale: plan wants %d workers, clamped to the "
                "job's [%d, %d] range → %d",
                target,
                self.min_workers,
                self.max_workers,
                clamped,
            )
            target = clamped
        logger.info(
            "auto-scale: %d → %d workers", self.job_manager.worker_num, target
        )
        self.job_manager.set_worker_num(target)
        self._last_scale_time = time.time()
        for mgr in self.rdzv_managers.values():
            mgr.update_rdzv_params(
                min_nodes=min(target, mgr._min_nodes or target),
                max_nodes=target,
            )
        sp = ScalePlan()
        sp.worker_num = target
        self.scaler.scale(sp)
