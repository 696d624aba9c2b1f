"""Per-host elastic agent: rendezvous → spawn workers → supervise → recover.

Port of ``dlrover_tpu/agent/agent.py`` (``ElasticLaunchConfig``,
``WorkerProcess``, ``ElasticTrainingAgent``; reference:
elastic_agent/torch/training.py:362-729). The JAX agent spawns one
worker a host (JAX owns every local chip); this one follows torch's
idiom, as the reference's own torch agent does: one worker process a
local GPU. Each gets ``LOCAL_RANK``, ``RANK`` = the node's offset in the
sealed world + ``LOCAL_RANK``, ``WORLD_SIZE`` = the world's GPUs and the
store's ``MASTER_ADDR``/``MASTER_PORT`` beside the JAX agent's
variables, whose values stay the JAX agent's (the node's group rank is
the JAX ``process_id``). A failed worker costs the node one restart of
its whole worker group: the others are stopped, the staged checkpoint
is persisted from this process (the attached ``AsyncCheckpointSaver``),
the node re-joins the rendezvous and respawns. The XLA compile-cache
variables of the JAX agent have no torch counterpart.

The heartbeat brings back the master's diagnosis actions, handled in
the JAX agent's order: ``abort_job`` (the workers stopped, the node
FAILED with ``fatal_error``, exit 1), ``relaunch_node`` (the workers
stopped, FAILED with ``killed``, which keeps the node's relaunch budget,
exit 2: the platform replaces the node), ``restart_worker`` (a restart
of the worker group while it runs). A worker that dies is reported and
respawned first; a relaunch its report prescribed is acted on at the
next poll. Each worker runs with ``DLROVER_TPU_STACK_DUMP=1`` (its
SIGUSR2 stack dump, ``collectors.StackCollector``).
"""

import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.collectors import StackCollector
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.rendezvous import (
    MasterRendezvousHandler,
    RendezvousOutcome,
)
from dlrover_tpu_torch.common.comm import find_free_port, split_addr
from dlrover_tpu_torch.common.constants import (
    DefaultValues,
    GraftEnv,
    NodeStatus,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)


@dataclass
class ElasticLaunchConfig:
    """Reference: ElasticLaunchConfig (training.py:117). ``local_chips``
    is the node's worker count (``--nproc``, one a GPU);
    ``coordinator_port`` the store port this node offers: -1 the
    master's default, 0 a free port picked at each join."""

    min_nodes: int = 1
    max_nodes: int = 1
    node_id: int = 0
    local_chips: int = 1
    max_restarts: int = DefaultValues.RELAUNCH_BUDGET
    monitor_interval_s: float = 2.0
    heartbeat_interval_s: float = DefaultValues.HEARTBEAT_INTERVAL_S
    rdzv_timeout_s: float = DefaultValues.RDZV_TIMEOUT_S
    network_check: bool = False
    comm_perf_test: bool = False
    exclude_straggler: bool = False
    node_unit: int = 1
    coordinator_port: int = -1
    entrypoint: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)

    def auto_configure(self):
        """Fill node/GPU counts and the store port from the environment."""
        if GraftEnv.NODE_NUM in os.environ:
            n = int(os.environ[GraftEnv.NODE_NUM])
            self.min_nodes = self.max_nodes = n
        if GraftEnv.NODE_ID in os.environ:
            self.node_id = int(os.environ[GraftEnv.NODE_ID])
        if GraftEnv.LOCAL_CHIPS in os.environ:
            self.local_chips = int(os.environ[GraftEnv.LOCAL_CHIPS])
        if os.environ.get(GraftEnv.COORDINATOR_PORT, "") != "":
            self.coordinator_port = int(os.environ[GraftEnv.COORDINATOR_PORT])


class WorkerProcess:
    """One training process (one GPU).

    stderr is teed: echoed through to the agent's stderr AND kept as a
    tail ring so failure reports carry the actual traceback."""

    def __init__(self, cmd: List[str], env: Dict[str, str]):
        self._cmd = cmd
        full_env = dict(os.environ)
        full_env.update(env)
        # SIGUSR2 Python-stack dumper for hang diagnosis (collectors.py)
        full_env.setdefault("DLROVER_TPU_STACK_DUMP", "1")
        self._tail: "deque[str]" = deque(maxlen=200)
        self._proc = subprocess.Popen(
            cmd, env=full_env, stderr=subprocess.PIPE, text=True
        )
        self._pump = threading.Thread(
            target=self._pump_stderr, name="worker-stderr", daemon=True
        )
        self._pump.start()

    def _pump_stderr(self):
        try:
            for line in self._proc.stderr:
                self._tail.append(line)
                try:
                    sys.stderr.write(line)
                except OSError:
                    # agent stderr gone (EPIPE): keep draining the pipe so
                    # the worker never blocks on a full buffer
                    pass
        except ValueError:  # stream closed during shutdown
            pass

    def stderr_tail(self, max_chars: int = 4000) -> str:
        # the pump races the exit we just observed — wait for it to drain
        # the pipe so the final traceback makes it into the report
        self._pump.join(timeout=5.0)
        return "".join(self._tail)[-max_chars:]

    @property
    def pid(self) -> int:
        return self._proc.pid

    def poll(self) -> Optional[int]:
        rc = self._proc.poll()
        if rc is not None:
            StackCollector.remove(self.pid)
        return rc

    def terminate(self, grace_s: float = 10.0):
        if self._proc.poll() is None:
            self._proc.send_signal(signal.SIGTERM)
            try:
                self._proc.wait(grace_s)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        StackCollector.remove(self.pid)


class ElasticTrainingAgent:
    def __init__(self, config: ElasticLaunchConfig, client: MasterClient):
        self.config = config
        self.client = client
        self._workers: List[WorkerProcess] = []
        self._outcome: Optional[RendezvousOutcome] = None
        self._remaining_restarts = config.max_restarts
        self._pending_restart = threading.Event()
        self._pending_abort = threading.Event()
        self._pending_relaunch = threading.Event()
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._ckpt_saver = None  # AsyncCheckpointSaver, attached by launcher

    def attach_ckpt_saver(self, saver):
        self._ckpt_saver = saver

    @property
    def restart_count(self) -> int:
        return self.config.max_restarts - self._remaining_restarts

    # ---- setup -----------------------------------------------------------

    def _start_heartbeats(self):
        """Keep the node alive in the master's ``JobManager`` and pick up
        the actions the diagnosis manager queued for it."""

        def loop():
            while not self._stop.wait(self.config.heartbeat_interval_s):
                try:
                    actions = self.client.heartbeat_with_actions()
                    for action in actions:
                        get_tracer().instant("failover.action",
                                             node=self.config.node_id,
                                             action=action)
                    if "restart_worker" in actions:
                        logger.info("master prescribed worker restart")
                        self._pending_restart.set()
                    if "abort_job" in actions:
                        logger.error("master prescribed job abort")
                        self._pending_abort.set()
                    if "relaunch_node" in actions:
                        logger.warning("master prescribed node relaunch")
                        self._pending_relaunch.set()
                except Exception:  # noqa: BLE001 — master may be restarting
                    logger.warning("heartbeat failed", exc_info=True)

        self._hb_thread = threading.Thread(
            target=loop, name="agent-heartbeat", daemon=True
        )
        self._hb_thread.start()

    def _offered_port(self) -> int:
        """The store port this node offers at a join: the configured one,
        a free one (0), or none (-1: the master's default)."""
        port = self.config.coordinator_port
        if port < 0:
            return 0
        return port or find_free_port()

    def _rendezvous(self) -> RendezvousOutcome:
        handler = MasterRendezvousHandler(
            self.client,
            self.client.node_rank,
            self.config.local_chips,
            timeout_s=self.config.rdzv_timeout_s,
            coordinator_port=self._offered_port,
        )
        with get_tracer().span(
            "failover.rendezvous", node=self.config.node_id
        ) as sp:
            outcome = handler.next_rendezvous()
            sp.args["rdzv_round"] = outcome.round
            sp.args["world_size"] = outcome.num_processes
        logger.info(
            "rendezvous round %d: %d nodes, %d workers, coordinator=%s",
            outcome.round,
            outcome.num_processes,
            outcome.global_chips,
            outcome.coordinator,
        )
        return outcome

    def _worker_env(self, outcome: RendezvousOutcome,
                    local_rank: int = 0) -> Dict[str, str]:
        """The JAX agent's variables, with its values, and torch's."""
        host, port = split_addr(outcome.coordinator)
        env = {
            GraftEnv.MASTER_ADDR: self.client.addr,
            GraftEnv.NODE_ID: str(self.config.node_id),
            GraftEnv.NODE_RANK: str(self.client.node_rank),
            GraftEnv.NODE_NUM: str(outcome.num_processes),
            # the process group's store, consumed by
            # dlrover_tpu_torch.train.distributed.init_distributed()
            "DLROVER_TPU_COORDINATOR": outcome.coordinator,
            "DLROVER_TPU_NUM_PROCESSES": str(outcome.num_processes),
            "DLROVER_TPU_PROCESS_ID": str(outcome.process_id),
            "DLROVER_TPU_RDZV_ROUND": str(outcome.round),
            "DLROVER_TPU_RESTART_COUNT": str(self.restart_count),
            # flight recorder: the worker's spans carry role=worker
            GraftEnv.TRACE_ROLE: "worker",
            # the entrypoint script must resolve the framework (and the
            # user's project) the same way the agent did
            "PYTHONPATH": os.pathsep.join(
                p
                for p in (
                    os.getcwd(),
                    os.environ.get("PYTHONPATH", ""),
                )
                if p
            ),
            # torch.distributed's own
            "RANK": str(outcome.rank_offset + local_rank),
            "LOCAL_RANK": str(local_rank),
            "WORLD_SIZE": str(outcome.global_chips),
            "LOCAL_WORLD_SIZE": str(self.config.local_chips),
            "GROUP_RANK": str(outcome.process_id),
            "MASTER_ADDR": host,
            "MASTER_PORT": str(port),
        }
        env.update(self.config.env)
        return env

    def _initialize_workers(self):
        self._outcome = self._rendezvous()
        self._workers = [
            WorkerProcess(self.config.entrypoint,
                          self._worker_env(self._outcome, lr))
            for lr in range(self.config.local_chips)
        ]
        get_tracer().instant(
            "failover.spawn",
            node=self.config.node_id,
            worker_pids=[w.pid for w in self._workers],
            rdzv_round=self._outcome.round,
            restart=self.restart_count,
        )
        logger.info(
            "spawned %d workers pids=%s round=%d",
            len(self._workers),
            [w.pid for w in self._workers],
            self._outcome.round,
        )

    def _terminate_workers(self):
        for w in self._workers:
            w.terminate()

    # ---- supervision hot loop -------------------------------------------

    def run(self) -> int:
        """Supervise until success, fatal failure, or restart exhaustion."""
        self.client.register_node(
            local_chips=self.config.local_chips,
            tpu_type=_local_device_kind(),
        )
        self._start_heartbeats()
        self._initialize_workers()
        try:
            return self._invoke_run()
        finally:
            self._stop.set()
            self._terminate_workers()

    def _safe_report(self, fn, *args, **kwargs):
        """Status reports must not crash the agent if the master is gone.
        Per-call retry cap so shutdown isn't held up by a dead master."""
        try:
            return fn(*args, retries=2, **kwargs)
        except Exception:  # noqa: BLE001
            logger.warning("master unreachable for %s", fn.__name__)
            return None

    def _invoke_run(self) -> int:
        while True:
            time.sleep(self.config.monitor_interval_s)
            rcs = [w.poll() for w in self._workers]
            if self._pending_abort.is_set():
                # diagnosis found the workload unrecoverable (user error,
                # OOM): stop spending the restart budget
                self._save_ckpt_to_storage()
                self._terminate_workers()
                self._safe_report(self.client.report_node_status,
                                  NodeStatus.FAILED,
                                  exit_reason="fatal_error")
                return 1
            if self._pending_relaunch.is_set():
                # a hardware fault: exit so the platform replaces the node;
                # "killed" keeps the node's relaunch budget
                get_tracer().instant("failover.relaunch",
                                     node=self.config.node_id)
                self._save_ckpt_to_storage()
                self._terminate_workers()
                self._safe_report(self.client.report_node_status,
                                  NodeStatus.FAILED, exit_reason="killed")
                return 2
            failed = [(lr, rc) for lr, rc in enumerate(rcs)
                      if rc is not None and rc != 0]
            if not failed:
                if all(rc == 0 for rc in rcs):
                    logger.info("worker succeeded")
                    self._safe_report(
                        self.client.report_node_status, NodeStatus.SUCCEEDED
                    )
                    return 0
                if any(rc is None for rc in rcs):
                    if self._pending_restart.is_set():
                        self._pending_restart.clear()
                        logger.info("diagnosis action: restarting workers")
                        self._save_ckpt_to_storage()
                        if not self._restart_worker():
                            return 1
                    elif self._membership_changed():
                        logger.info(
                            "membership changed; checkpoint + restart "
                            "workers")
                        self._save_ckpt_to_storage()
                        if not self._restart_worker():
                            return 1
                continue
            # failure path (reference: training.py:687,665,704)
            lr, rc = failed[0]
            logger.warning("worker exited rc=%d (local rank %d)", rc, lr)
            # detect mark: everything downstream (persist, rendezvous,
            # respawn, first step back) is measured from here
            get_tracer().instant(
                "failover.worker_exit", node=self.config.node_id, rc=rc,
                local_rank=lr,
            )
            # the group's other workers cannot step without this one
            self._terminate_workers()
            self._safe_report(
                self.client.report_failure,
                f"worker exit code {rc}\n{self._workers[lr].stderr_tail()}",
                level=TrainingExceptionLevel.PROCESS_ERROR,
                restart_count=self.restart_count,
            )
            self._save_ckpt_to_storage()
            if self._remaining_restarts > 0:
                self._remaining_restarts -= 1
                if not self._restart_worker():
                    return rc
            else:
                self._safe_report(
                    self.client.report_node_status,
                    NodeStatus.FAILED,
                    exit_reason="fatal_error",
                )
                return rc

    def _membership_changed(self) -> bool:
        """A node is waiting to join (scale-up) or the world shrank."""
        try:
            return self.client.num_nodes_waiting() > 0
        except Exception:  # noqa: BLE001
            return False

    def _restart_worker(self) -> bool:
        """Re-rendezvous + respawn. False when the master is gone (job over
        or master crashed) — the caller exits instead of raising."""
        # a restart satisfies any restart prescription that raced with it
        self._pending_restart.clear()
        if self._workers:
            self._terminate_workers()
            self._safe_report(
                self.client.report_worker_restart, "planned restart"
            )
        try:
            self._initialize_workers()
            return True
        except Exception:  # noqa: BLE001
            logger.exception(
                "restart rendezvous failed; master unreachable — exiting"
            )
            return False

    def _save_ckpt_to_storage(self):
        """Persist any staged in-memory checkpoint before losing the world."""
        if self._ckpt_saver is not None:
            with get_tracer().span(
                "failover.ckpt_persist", node=self.config.node_id
            ):
                try:
                    self._ckpt_saver.save_shm_to_storage()
                except Exception:  # noqa: BLE001
                    logger.exception("emergency checkpoint persist failed")


def _local_device_kind() -> str:
    """The node's GPU model from ``nvidia-smi`` ("cpu" without one): the
    agent must not open a CUDA context on a card its workers use."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "cpu"
    names = out.stdout.strip().splitlines()
    return names[0].strip() if out.returncode == 0 and names else "cpu"
