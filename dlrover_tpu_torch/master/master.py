"""Job masters: compose managers + transport; supervision loop.

Port of ``dlrover_tpu/master/master.py`` (``JobMaster``,
``LocalJobMaster``, ``run``): the node manager, the training
rendezvous, the KV store, the sync service, the speed monitor, the
data-shard task manager (started and stopped with the master), the job
metric collector with its goodput tracker and its HTTP endpoint
(``job_metrics.py``: ``/metrics`` and ``/json`` on the port the master
logs at ``prepare``), and the master's own telemetry hub: the servicer
publishes onto it the agents' resource stats and the records workers
send (``TelemetryEventReport``), the speed monitor its straggler flags;
the collector (``MetricsSink``), a JSONL flight recorder under
``DLROVER_TPU_TELEMETRY_DIR``, the diagnosis manager and the
``HealthAggregator`` (the workers' AnomalyRecords → HealthSummary)
consume it. All of it behind one ``MasterServicer`` on the two-RPC
transport; the node-event callbacks (``event_callback.py``: shard
re-queue, rendezvous prune, a chief past its budget failing the job);
and the loop that records the job's runtime, ends the job when every
worker has exited and kicks every node to restart its worker when all
of them have idled a whole hang window (a cooldown between kicks).

Goodput: the tracker is stalled from the start, at a node down (from
the step training had reached), at a hang kick (backdated by the hang
window) and at the servicer's worker restart and failure reports, and
each stall closes at the first step report that advances past it; a
worker's SUCCEEDED closes the accounting.

The planning loop: the sparse tier's ``ElasticPsService`` (its
``PsClusterCallback`` on the node events, its versions behind the
servicer) and, when the job declares an elastic range (``max_workers >
num_workers``), a ``JobAutoScaler`` over ``LocalHeuristicOptimizer`` or,
with ``optimize_mode="cluster"``, over a ``BrainClient`` to the Brain
at ``brain_addr`` (``cluster/brain.py``); the auto-scaler starts and
stops with the master, and ``stop()`` closes the Brain client. Its
``ScalePlan`` goes to the master's ``scaler`` (a ``NoopScaler`` unless
the platform gives one). The network-check rendezvous
(``NetworkCheckRendezvousManager``) pairs the nodes that run the
launcher's ``--network-check``, as the JAX master's does.
"""

import os
import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.comm import MasterTransportServer
from dlrover_tpu_torch.common.constants import (
    GraftEnv,
    JobExitReason,
    RendezvousName,
)
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.diagnosis.manager import DiagnosisManager
from dlrover_tpu_torch.master.event_callback import (
    ClusterContext,
    default_callbacks,
)
from dlrover_tpu_torch.master.job_metrics import (
    GoodputTracker,
    JobMetricCollector,
    MetricsHTTPServer,
)
from dlrover_tpu_torch.master.auto_scaler import JobAutoScaler
from dlrover_tpu_torch.master.elastic_ps import (
    ElasticPsService,
    PsClusterCallback,
)
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.node_manager import JobManager, Scaler
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.task_manager import TaskManager
from dlrover_tpu_torch.master.sync_service import SyncService
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.observability.watchdog import HealthAggregator

logger = get_logger(__name__)


class JobMaster:
    """Composition root; subclasses pick scaler flavors."""

    def __init__(
        self,
        port: int = 0,
        num_workers: int = 1,
        max_workers: Optional[int] = None,
        node_unit: int = 1,
        scaler: Optional[Scaler] = None,
        enable_auto_scaling: Optional[bool] = None,
        optimize_mode: str = "single-job",
        brain_addr: str = "",
        job_name: str = "",
        job_kind: str = "",
    ):
        # validate before any server is built: raising after the
        # transport bound its port would leak it
        if optimize_mode == "cluster" and not brain_addr:
            raise ValueError(
                "optimize_mode='cluster' needs brain_addr "
                "(host:port of a Brain: python -m "
                "dlrover_tpu_torch.cluster.brain)"
            )
        ctx = get_context()
        self.optimize_mode = optimize_mode
        self.brain_addr = brain_addr
        self.job_name = job_name
        self.job_kind = job_kind
        self.speed_monitor = SpeedMonitor()
        self.task_manager = TaskManager(shard_timeout_s=ctx.shard_timeout_s)
        self.task_manager.speed_monitor = self.speed_monitor
        self.job_manager = JobManager(
            num_workers=num_workers,
            relaunch_budget=ctx.relaunch_budget,
            heartbeat_timeout_s=ctx.heartbeat_timeout_s,
            pending_timeout_s=ctx.pending_timeout_s,
            scaler=scaler,
        )
        self.rdzv_managers: Dict[str, object] = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        max_w = max_workers or num_workers
        for mgr in self.rdzv_managers.values():
            mgr.update_rdzv_params(
                min_nodes=num_workers,
                max_nodes=max_w,
                waiting_timeout=ctx.rdzv_wait_extra_nodes_s,
                node_unit=node_unit,
            )
        self.kv_store = KVStoreService()
        self.sync_service = SyncService()
        self.sync_service.set_world_size_fn(
            lambda: len(self.job_manager.running_nodes()) or 1
        )
        self.diagnosis_manager = DiagnosisManager()
        self.metric_collector = JobMetricCollector()
        self.goodput_tracker = GoodputTracker()
        self.metric_collector.goodput_tracker = self.goodput_tracker
        self.metrics_server = MetricsHTTPServer(self.metric_collector, port=0)
        # a master-local hub (not the process one), so masters composed in
        # one process do not cross wires
        self.telemetry_hub = telemetry.TelemetryHub()
        self.telemetry_hub.add_sink(
            telemetry.MetricsSink(self.metric_collector))
        tdir = os.getenv(GraftEnv.TELEMETRY_DIR)
        if tdir:
            self.telemetry_hub.add_sink(telemetry.JsonlSink(os.path.join(
                tdir, f"telemetry-master-{os.getpid()}.jsonl")))
        self.diagnosis_manager.attach(self.telemetry_hub)
        self.speed_monitor.attach_hub(self.telemetry_hub)
        # cross-host correlation of the workers' AnomalyRecords
        self.health_aggregator = HealthAggregator(
            hub=self.telemetry_hub, world=num_workers)
        self.ps_service = ElasticPsService()
        self.servicer = MasterServicer(
            job_manager=self.job_manager,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            sync_service=self.sync_service,
            speed_monitor=self.speed_monitor,
            task_manager=self.task_manager,
            diagnosis_manager=self.diagnosis_manager,
            goodput_tracker=self.goodput_tracker,
            metric_collector=self.metric_collector,
            telemetry_hub=self.telemetry_hub,
            ps_service=self.ps_service,
        )
        self.server = MasterTransportServer(self.servicer, port=port)
        # the auto-scaler runs whenever the job declared an elastic range
        if enable_auto_scaling is None:
            enable_auto_scaling = max_w > num_workers
        # cluster mode: plans from the shared Brain in place of the local
        # heuristic; the client is built only when an auto-scaler will
        # consume it, and closed in stop()
        optimizer = None
        self._brain_client = None
        if optimize_mode == "cluster":
            if not enable_auto_scaling:
                logger.warning(
                    "optimize_mode='cluster' has no effect without auto "
                    "scaling (max_workers == num_workers); brain %s "
                    "will not be consulted", brain_addr)
            else:
                from dlrover_tpu_torch.cluster.brain import BrainClient

                optimizer = BrainClient(brain_addr)
                optimizer.bind_job(job_name or "job", job_kind)
                self._brain_client = optimizer
        self.auto_scaler: Optional[JobAutoScaler] = None
        if enable_auto_scaling:
            self.auto_scaler = JobAutoScaler(
                self.job_manager,
                self.speed_monitor,
                self.job_manager._scaler,
                rdzv_managers=self.rdzv_managers,
                optimizer=optimizer,
                min_workers=num_workers,
                max_workers=max_w,
                node_unit=node_unit,
                interval_s=ctx.autoscale_interval_s,
                ps_service=self.ps_service,
            )
        self._stop = threading.Event()
        self._last_hang_kick = 0.0
        self.exit_reason = ""
        self.job_manager.cluster_context = ClusterContext(
            self.job_manager, task_manager=self.task_manager,
            rdzv_managers=self.rdzv_managers,
            speed_monitor=self.speed_monitor)
        self.job_manager.event_callbacks.extend(default_callbacks(
            task_manager=self.task_manager,
            rdzv_managers=self.rdzv_managers,
            on_job_failed=self._fail_job))
        # PS-typed node lifecycle drives the versioned sparse server set
        self.job_manager.event_callbacks.append(
            PsClusterCallback(self.ps_service))
        self.job_manager.node_failed_callbacks.append(self._on_node_down)

    def _fail_job(self, reason: str):
        self.exit_reason = JobExitReason.RELAUNCH_BUDGET_EXHAUSTED
        logger.error("job failed: %s", reason)
        self._stop.set()

    def _on_node_down(self, node):
        self.speed_monitor.reset_running_speed()
        self.speed_monitor.drop_node(node.id)
        self.metric_collector.inc("node_failures_total")
        # lost time runs from here until a step report ADVANCES past the
        # step training had reached when the node went down
        self.goodput_tracker.mark_stalled(
            at_step=self.speed_monitor.global_step)
        get_tracer().instant(
            "failover.detect", node=node.id, source="heartbeat_timeout"
        )
        self.telemetry_hub.publish(telemetry.ElasticEvent(
            kind="node_down", node_id=node.id, detail="heartbeat_timeout"))

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def addr(self) -> str:
        return f"localhost:{self.server.port}"

    def prepare(self):
        self.server.start()
        self.metrics_server.start()
        logger.info("metrics endpoint on port %d", self.metrics_server.port)
        self.task_manager.start()
        self.job_manager.start()
        if self.auto_scaler is not None:
            self.auto_scaler.start()

    def run(self, poll_interval_s: Optional[float] = None) -> str:
        """Supervision loop (reference: dist_master.py:211)."""
        ctx = get_context()
        interval = poll_interval_s or ctx.supervise_interval_s
        try:
            while not self._stop.wait(interval):
                self.metric_collector.collect_runtime(
                    self.speed_monitor.global_step,
                    self.speed_monitor.running_speed,
                    len(self.job_manager.running_nodes()))
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_succeeded():
                        self.exit_reason = JobExitReason.SUCCEEDED
                    else:
                        self.exit_reason = (
                            JobExitReason.RELAUNCH_BUDGET_EXHAUSTED
                        )
                    break
                if self.job_manager.pending_timeout():
                    self.exit_reason = JobExitReason.PENDING_TIMEOUT
                    break
                self._kick_if_hanged(ctx.hang_kick_cooldown_s)
        finally:
            self.stop()
        logger.info("master exiting: %s", self.exit_reason)
        return self.exit_reason

    def _kick_if_hanged(self, cooldown_s: float) -> bool:
        """A job-wide hang (reference: dist_job_manager.py:802): every
        node idle over the window gets a restart prescription; the
        cooldown leaves the restart and re-rendezvous time to land fresh
        samples before the next kick. Progress stopped at the START of
        the idle window, so the goodput stall is backdated by it (clamped
        inside the tracker)."""
        if (time.time() - self._last_hang_kick <= cooldown_s
                or not self.diagnosis_manager.all_nodes_hanged()):
            return False
        self._last_hang_kick = time.time()
        self.goodput_tracker.mark_stalled(
            at_step=self.speed_monitor.global_step,
            accounted_from=time.monotonic()
            - self.diagnosis_manager.HANG_WINDOW_S)
        logger.warning("all nodes idle — prescribing restart")
        self.diagnosis_manager.queue_action_for(
            [n.id for n in self.job_manager.running_nodes()],
            "restart_worker")
        return True

    def request_stop(self, reason: str = ""):
        self.exit_reason = reason or self.exit_reason
        self._stop.set()

    def stop(self):
        self._stop.set()
        if self.auto_scaler is not None:
            self.auto_scaler.stop()
        if self._brain_client is not None:
            self._brain_client.close()
        for name, n in self.task_manager.completed_counts().items():
            logger.info("dataset %s: %d shards completed", name, n)
        self.task_manager.stop()
        self.job_manager.stop()
        self.metrics_server.stop()
        self.server.stop()


class LocalJobMaster(JobMaster):
    """In-process master for a single-host launcher run."""


class DistributedJobMaster(JobMaster):
    """Multi-host master (``master/main.py``). A platform scaler and pod
    watcher attach here (``cluster/scaler.py``, ``cluster/kube.py``):
    like the JAX entry point, ``master/main.py`` attaches neither."""

