"""Failure diagnosis: collect, classify, prescribe.

Port of ``dlrover_tpu/diagnosis/manager.py`` (reference: dlrover's
master/diagnosis/, DiagnosisManager diagnosis.py:31, and
monitor/error_monitor.py:22). The master collects the agents' failure
reports and resource stats, classifies a failure by the worker's
stderr, and queues an action for the node's next heartbeat: restart
the worker, relaunch the node, or abort the job.

``_FAILURE_RULES`` is the JAX table, rule for rule, in its order (the
first rule that matches wins), with the card's counterpart of each
failure beside the JAX rule: the same class and action read against
CUDA's, cuBLAS's, NCCL's and the driver's messages (a CUDA allocator
or cuBLAS allocation failure is ``oom``; an uncorrectable ECC error, an
Xid, an NVLink error or NCCL's ``unhandled system error`` is
``hardware_error``; the NCCL watchdog's collective timeout is
``hang``; a worker ended by SIGTERM from outside is ``preempted``; a
kernel image the card cannot run is ``user_error``). The JAX rules
match case-insensitively anywhere in the report, whose text is the
worker's whole stderr tail: its ``OOM`` alternative also matches a word
such as "room" (ROADMAP C).
"""

import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class DiagnosisAction:
    NONE = "none"
    RESTART_WORKER = "restart_worker"
    RELAUNCH_NODE = "relaunch_node"
    ABORT_JOB = "abort_job"


# error signature -> (classification, action)
_FAILURE_RULES = [
    (r"RESOURCE_EXHAUSTED|out of memory|OOM", "oom",
     DiagnosisAction.ABORT_JOB),
    (r"CUBLAS_STATUS_ALLOC_FAILED|cudaErrorMemoryAllocation", "oom",
     DiagnosisAction.ABORT_JOB),
    (r"(slice|ICI|interconnect).*(fail|error|down)", "hardware_error",
     DiagnosisAction.RELAUNCH_NODE),
    (r"uncorrectable ECC error|cudaErrorECCUncorrectable|\bXid\b|"
     r"NVLink.*(fail|error|down)|unhandled system error|"
     r"fallen off the bus", "hardware_error",
     DiagnosisAction.RELAUNCH_NODE),
    (r"(DEADLINE_EXCEEDED|barrier timeout|heartbeat)", "hang",
     DiagnosisAction.RESTART_WORKER),
    (r"Watchdog caught collective operation timeout|NCCL.*timed out",
     "hang", DiagnosisAction.RESTART_WORKER),
    (r"(UNAVAILABLE|coordination service|preempt)", "preempted",
     DiagnosisAction.RELAUNCH_NODE),
    (r"got signal: 15|exit code -15\b", "preempted",
     DiagnosisAction.RELAUNCH_NODE),
    (r"(SyntaxError|ImportError|ModuleNotFoundError|TypeError)",
     "user_error", DiagnosisAction.ABORT_JOB),
    (r"no kernel image is available for execution|"
     r"CUDA driver version is insufficient", "user_error",
     DiagnosisAction.ABORT_JOB),
]


@dataclass
class FailureRecord:
    node_id: int
    error_data: str
    level: str
    classification: str = "unknown"
    action: str = DiagnosisAction.NONE
    timestamp: float = field(default_factory=time.time)


def classify_failure(error_data: str) -> tuple:
    for pattern, cls, action in _FAILURE_RULES:
        if re.search(pattern, error_data, re.IGNORECASE):
            return cls, action
    return "unknown", DiagnosisAction.RESTART_WORKER


class DiagnosisManager:
    # the idle window before a job-wide hang verdict
    HANG_WINDOW_S = 600.0

    def __init__(self, hang_cpu_percent: float = 5.0, window: int = 512):
        self._lock = threading.Lock()
        self.failures: Deque[FailureRecord] = deque(maxlen=window)
        self.resource_history: Dict[int, Deque] = {}
        self.diagnosis_data: Dict[int, Deque] = {}
        self._hang_cpu_percent = hang_cpu_percent
        self._window = window
        # node id -> actions queued for that node's next heartbeat
        self._pending_actions: Dict[int, List[str]] = {}

    # ---- telemetry-bus subscription --------------------------------------

    def attach(self, hub) -> None:
        """Subscribe to the master's telemetry hub: resource records feed
        the hang detector's history; straggler flags and numeric incidents
        are filed as evidence (the JAX manager's anomaly and health
        records come with their producers, ROADMAP A12)."""
        hub.subscribe(self._on_record,
                      types=("AnomalyRecord", "HealthSummary",
                             "NumericEvent", "ResourceRecord",
                             "StragglerRecord"))

    def _on_record(self, record) -> None:
        tname = type(record).__name__
        if tname == "ResourceRecord":
            with self._lock:
                hist = self.resource_history.setdefault(record.node_id,
                                                        deque(maxlen=64))
                hist.append({"t": time.time(), "cpu": record.cpu_percent,
                             "mem_mb": record.mem_mb, "hbm_mb": record.hbm_mb,
                             "hbm_peak_mb": record.hbm_peak_mb})
        elif tname == "StragglerRecord":
            self.collect_diagnosis_data(
                record.node_id,
                f"straggler: step={record.step} max_step={record.max_step}"
                f" lag={record.lag_steps} ratio={record.ratio:.2f}")
        elif tname == "NumericEvent":
            # no node id on the record: filed under the job bucket -1
            self.collect_diagnosis_data(
                -1, f"numeric {record.kind} at step {record.step}: "
                f"value={record.value} {record.detail}")
        elif tname == "AnomalyRecord":
            self.collect_diagnosis_data(
                record.node_id,
                f"anomaly {record.kind} at step {record.step}: "
                f"value={record.value} {record.detail}"
                + (f" capture={record.capture}" if record.capture else ""))
        elif tname == "HealthSummary":
            content = (f"health {record.kind}: verdict={record.verdict} "
                       f"ranks=[{record.ranks}] of world={record.world}, "
                       f"first bad step {record.first_step}")
            self.collect_diagnosis_data(-1, content)
            for rank in record.ranks.split(","):
                if rank.strip():
                    self.collect_diagnosis_data(int(rank), content)

    # ---- collection ------------------------------------------------------

    def collect_failure(self, msg, worker_alive: bool = False
                        ) -> FailureRecord:
        """Classify a failure report and queue its action. A restart is
        the agent's own reaction to a dead worker: queued again it would
        restart twice, so it is queued only for a worker still alive (a
        hang report); the stronger actions always are."""
        cls, action = classify_failure(msg.error_data)
        queue_action = action
        if action == DiagnosisAction.RESTART_WORKER and not worker_alive:
            queue_action = DiagnosisAction.NONE
        rec = FailureRecord(node_id=msg.node_id, error_data=msg.error_data,
                            level=msg.level, classification=cls,
                            action=action)
        with self._lock:
            self.failures.append(rec)
            if queue_action != DiagnosisAction.NONE:
                self._pending_actions.setdefault(msg.node_id, []).append(
                    queue_action)
        logger.info("diagnosed node %d failure as %s → %s", msg.node_id,
                    cls, action)
        return rec

    def collect_diagnosis_data(self, node_id: int, content: str):
        """File an agent collector's payload (log tail, stack, proc state)
        as evidence, with no failure side effect."""
        with self._lock:
            hist = self.diagnosis_data.setdefault(node_id, deque(maxlen=32))
            hist.append({"t": time.time(), "content": content[:8000]})

    def collect_resource(self, msg):
        with self._lock:
            hist = self.resource_history.setdefault(msg.node_id,
                                                    deque(maxlen=64))
            hist.append({"t": time.time(), "cpu": msg.cpu_percent,
                         "mem_mb": msg.used_memory_mb,
                         "hbm_mb": msg.hbm_used_mb})

    # ---- queries ---------------------------------------------------------

    def queue_action_for(self, node_ids, action: str):
        """Queue an action for a set of nodes (abort fan-out, hang kick)."""
        with self._lock:
            for nid in node_ids:
                pending = self._pending_actions.setdefault(nid, [])
                if action not in pending:
                    pending.append(action)

    def take_actions(self, node_id: int) -> List[str]:
        """Drain a node's queued actions (a heartbeat's response)."""
        with self._lock:
            return self._pending_actions.pop(node_id, [])

    def all_nodes_hanged(self, min_duration_s: float = HANG_WINDOW_S
                         ) -> bool:
        """Every node's CPU ~idle over the whole window: a job hang
        (reference: dist_job_manager.py:802 all_running_node_hanged)."""
        now = time.time()
        with self._lock:
            if not self.resource_history:
                return False
            for hist in self.resource_history.values():
                recent = [h for h in hist if now - h["t"] <= min_duration_s]
                if not recent or any(h["cpu"] > self._hang_cpu_percent
                                     for h in recent):
                    return False
                if hist and now - hist[0]["t"] < min_duration_s:
                    return False
            return True

    def failure_summary(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for rec in self.failures:
                out[rec.classification] = out.get(rec.classification, 0) + 1
            return out
