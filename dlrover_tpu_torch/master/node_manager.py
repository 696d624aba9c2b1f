"""Job-level node lifecycle management.

Port of ``dlrover_tpu/master/node_manager.py`` (``JobManager``,
``NoopScaler``): the master's record of every node, fed by
registrations, heartbeats, status reports and platform events; status
transitions go through ``status_flow``; a failed or deleted node is
relaunched while its budget lasts (a ``ScalePlan`` for the scaler).
Observers (``event_callbacks``: objects with ``on_node_started``,
``on_node_succeeded``, ``on_node_failed``, ``on_node_deleted``) hear of
each transition; the master wires the rendezvous prune and the sparse
tier's server set through them. The auto-scaler moves the worker count
(``set_worker_num``: a scale-in releases the highest-indexed nodes, so
their exits are not failures to relaunch), and the Brain's tuning plans
are versioned here (``plan_tuning``: one monotonic counter, the latest
directive kept; the ``ParallelConfig`` poll serves it). Serving
replicas register as ``NodeType.SERVING`` nodes tagged with their pool
(``serving_nodes``); their page-migration and scale directives are
versioned here too (``plan_serving_reshard``, ``plan_serving_scale``).
"""

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    DefaultValues,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.messages import NodeMeta
from dlrover_tpu_torch.common.node import Node, NodeResource
from dlrover_tpu_torch.master.status_flow import transition
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)


@dataclass
class NodeEvent:
    event_type: str
    node_id: int
    status: str = ""
    exit_reason: str = ""
    # which incarnation of the node the event is about; -1 = unknown →
    # always accepted (guards relaunches against stale events)
    incarnation: int = -1


class ScalePlan:
    """What the scaler must do (reference: scaler/base_scaler.py ScalePlan)."""

    def __init__(self):
        self.launch_nodes: List[Node] = []
        self.remove_nodes: List[Node] = []
        self.worker_num: Optional[int] = None

    def empty(self) -> bool:
        return not self.launch_nodes and not self.remove_nodes and (
            self.worker_num is None
        )

    def __repr__(self):
        return (
            f"ScalePlan(launch={[n.name for n in self.launch_nodes]}, "
            f"remove={[n.name for n in self.remove_nodes]}, "
            f"worker_num={self.worker_num})"
        )


class Scaler:
    """Executes ScalePlans on the platform."""

    def scale(self, plan: ScalePlan):
        raise NotImplementedError


class NoopScaler(Scaler):
    def __init__(self):
        self.plans: List[ScalePlan] = []

    def scale(self, plan: ScalePlan):
        self.plans.append(plan)


class JobManager:
    """Track nodes, consume events, decide relaunches."""

    def __init__(
        self,
        num_workers: int = 1,
        relaunch_budget: int = DefaultValues.RELAUNCH_BUDGET,
        heartbeat_timeout_s: float = DefaultValues.HEARTBEAT_TIMEOUT_S,
        pending_timeout_s: float = DefaultValues.PENDING_TIMEOUT_S,
        scaler: Optional[Scaler] = None,
    ):
        self._lock = threading.Lock()
        self._nodes: Dict[int, Node] = {}
        self._num_workers = num_workers
        self._relaunch_budget = relaunch_budget
        self._heartbeat_timeout_s = heartbeat_timeout_s
        self._pending_timeout_s = pending_timeout_s
        self._scaler = scaler or NoopScaler()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._start_time = time.time()
        self.node_failed_callbacks: List[Callable[[Node], None]] = []
        self.node_succeeded_callbacks: List[Callable[[Node], None]] = []
        self.event_callbacks: List[Any] = []
        self.cluster_context: Any = None
        # Brain tuning directives (cluster/brain.py): one monotonic
        # version counter, the latest plan or revision kept; trainers
        # pick it up through the ParallelConfig poll (tuning_json)
        self._tuning_version = 0
        self._tuning: Optional[Dict] = None
        # serving directives: the page-migration one (the latest kept)
        # and the scale ones (the latest a role), each on its own
        # monotonic counter
        self._serving_reshard_version = 0
        self._serving_reshard: Optional[Dict] = None
        self._serving_scale_version = 0
        self._serving_scale: Dict[str, Dict] = {}
        self._init_nodes()

    def _init_nodes(self):
        for i in range(self._num_workers):
            self._nodes[i] = Node(
                node_type=NodeType.WORKER,
                node_id=i,
                rank_index=i,
                max_relaunch_count=self._relaunch_budget,
            )
            self._nodes[i].create_time = time.time()

    # ---- lifecycle -------------------------------------------------------

    def start(self):
        t = threading.Thread(
            target=self._monitor_heartbeats, name="hb-monitor", daemon=True
        )
        t.start()
        self._threads.append(t)

    def stop(self):
        self._stop.set()

    # ---- RPC-surface handlers -------------------------------------------

    def register_node(self, meta: NodeMeta, restart_count: int = 0) -> Node:
        with self._lock:
            node = self._nodes.get(meta.node_id)
            if node is None:
                node = Node(
                    node_type=meta.node_type or NodeType.WORKER,
                    node_id=meta.node_id,
                    rank_index=(
                        meta.node_rank if meta.node_rank >= 0 else meta.node_id
                    ),
                    max_relaunch_count=self._relaunch_budget,
                )
                self._nodes[meta.node_id] = node
            elif meta.node_type and node.type != meta.node_type:
                if node.name == f"{node.type}-{node.id}":
                    node.name = f"{meta.node_type}-{node.id}"
                node.type = meta.node_type
            node.host_addr = meta.host_addr
            if meta.role:
                node.role = meta.role
            node.config_resource = NodeResource(
                chips=meta.local_chips, device_kind=meta.tpu_type
            )
            node.heartbeat_time = time.time()
            prev_status = node.status
            prev_rc = node.agent_restart_count
            node.agent_restart_count = max(prev_rc, restart_count)
            self._apply_status(node, NodeStatus.RUNNING)
            started = node.status == NodeStatus.RUNNING and (
                prev_status != NodeStatus.RUNNING
                or restart_count > prev_rc
            )
            logger.info("registered %s from %s", node, meta.host_addr)
        # outside the lock: observers may call back into query methods
        if started:
            self._fire("on_node_started", node)
        return node

    def handle_heartbeat(self, node_id: int) -> List[str]:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return []
            node.heartbeat_time = time.time()
            return []

    def handle_status_report(
        self, node_id: int, status: str, exit_reason: str = ""
    ):
        self.process_event(
            NodeEvent(
                NodeEventType.MODIFIED,
                node_id,
                status=status,
                exit_reason=exit_reason,
            )
        )

    # ---- event processing ------------------------------------------------

    def process_event(self, event: NodeEvent):
        with self._lock:
            node = self._nodes.get(event.node_id)
            if node is None:
                return
            if 0 <= event.incarnation < node.incarnation:
                return  # stale: about a node this one already replaced
            if event.event_type == NodeEventType.HEARTBEAT_TIMEOUT:
                status = NodeStatus.FAILED
                node.exit_reason = NodeExitReason.KILLED
            elif event.event_type == NodeEventType.DELETED:
                status = NodeStatus.DELETED
                node.exit_reason = event.exit_reason or NodeExitReason.KILLED
            else:
                status = event.status
                if event.exit_reason:
                    node.exit_reason = event.exit_reason
            flow = transition(node.status, status)
            if not flow.allowed:
                return
            self._apply_status(node, status)

        if status in (NodeStatus.FAILED, NodeStatus.DELETED):
            self._fire(
                "on_node_deleted"
                if status == NodeStatus.DELETED
                else "on_node_failed",
                node,
            )
            self._on_node_down(node)
        elif status == NodeStatus.SUCCEEDED:
            self._fire("on_node_succeeded", node)
            for cb in self.node_succeeded_callbacks:
                cb(node)
        elif status == NodeStatus.RUNNING:
            self._fire("on_node_started", node)

    def _apply_status(self, node: Node, status: str):
        flow = transition(node.status, status)
        if flow.allowed:
            node.update_status(status)

    def _fire(self, hook: str, node: Node):
        """Dispatch one lifecycle hook to every registered observer; an
        observer exception never breaks node bookkeeping."""
        for cb in self.event_callbacks:
            fn = getattr(cb, hook, None)
            if fn is None:
                continue
            try:
                fn(node, self.cluster_context)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "event callback %s.%s failed", type(cb).__name__, hook
                )

    def _on_node_down(self, node: Node):
        if node.is_released:
            return  # removed on purpose (scale-in): not a failure
        for cb in self.node_failed_callbacks:
            cb(node)
        if node.should_relaunch():
            node.inc_relaunch_count()
            self._relaunch_node(node)
        else:
            logger.warning(
                "%s exhausted relaunch budget (reason=%s)",
                node,
                node.exit_reason,
            )

    def _relaunch_node(self, node: Node):
        logger.info(
            "relaunching %s (attempt %d/%d, reason=%s)",
            node.name,
            node.relaunch_count,
            node.max_relaunch_count,
            node.exit_reason,
        )
        with self._lock:
            new_node = node.new_incarnation()
            self._nodes[node.id] = new_node
        plan = ScalePlan()
        plan.launch_nodes.append(new_node)
        self._scaler.scale(plan)

    # ---- monitors --------------------------------------------------------

    def _monitor_heartbeats(self):
        interval = min(30.0, self._heartbeat_timeout_s / 4)
        while not self._stop.wait(interval):
            now = time.time()
            dead: List[int] = []
            with self._lock:
                for node in self._nodes.values():
                    if node.status != NodeStatus.RUNNING:
                        continue
                    last = node.heartbeat_time or node.create_time or now
                    if now - last > self._heartbeat_timeout_s:
                        dead.append(node.id)
            for node_id in dead:
                logger.warning("node %d heartbeat timeout", node_id)
                self.process_event(
                    NodeEvent(NodeEventType.HEARTBEAT_TIMEOUT, node_id)
                )

    # ---- job-level queries ----------------------------------------------

    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def running_nodes(self) -> List[Node]:
        with self._lock:
            return [
                n
                for n in self._nodes.values()
                if n.status == NodeStatus.RUNNING
            ]

    def nodes_of_type(self, node_type: str) -> List[Node]:
        with self._lock:
            return [n for n in self._nodes.values() if n.type == node_type]

    def serving_nodes(self, role: Optional[str] = None) -> List[Node]:
        """Generation-serving replicas (``serving/replica.py``). They
        register like trainer nodes, heartbeats and failure detection
        included, but live outside the train rendezvous, so job
        completion never waits on them. ``role`` filters a
        disaggregated fleet to one pool ("prefill" / "decode" /
        "unified") so each can be scaled on its own."""
        nodes = self.nodes_of_type(NodeType.SERVING)
        if role is None:
            return nodes
        return [n for n in nodes if n.role == role]

    def all_workers_exited(self) -> bool:
        with self._lock:
            return all(
                n.is_exited()
                for n in self._nodes.values()
                if n.type in (NodeType.WORKER, NodeType.CHIEF)
            )

    def all_workers_succeeded(self) -> bool:
        with self._lock:
            return all(
                n.status == NodeStatus.SUCCEEDED
                for n in self._nodes.values()
                if n.type in (NodeType.WORKER, NodeType.CHIEF)
            )

    def all_evaluators_exited(self) -> bool:
        with self._lock:
            return all(n.is_exited() for n in self._nodes.values()
                       if n.type == NodeType.EVALUATOR)

    def pending_timeout(self) -> bool:
        now = time.time()
        with self._lock:
            for n in self._nodes.values():
                if n.status in (NodeStatus.INITIAL, NodeStatus.PENDING):
                    created = n.create_time or self._start_time
                    if now - created > self._pending_timeout_s:
                        return True
            return False

    def release_node(self, node_id: int):
        """Mark a node as removed on purpose (scale-in): its exit must
        not trigger a relaunch."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                node.is_released = True

    def set_worker_num(self, n: int):
        """Elastic scale target; new node slots get fresh bookkeeping.
        Scale-in releases the highest-indexed nodes (the scaler's
        drop-highest-first policy) so their exits read as intentional,
        not as failures to relaunch."""
        with self._lock:
            self._num_workers = n
            for i, node in self._nodes.items():
                if i >= n and not node.is_exited():
                    node.is_released = True
            for i in range(n):
                if i not in self._nodes:
                    node = Node(
                        node_type=NodeType.WORKER,
                        node_id=i,
                        rank_index=i,
                        max_relaunch_count=self._relaunch_budget,
                    )
                    node.create_time = time.time()
                    self._nodes[i] = node

    # ---- Brain tuning directives -----------------------------------------

    def plan_tuning(self, plan_json: str, reason: str = "") -> int:
        """Version one Brain tuning plan or revision (a
        ``cluster/brain.py`` TuningPlan as its asdict JSON): a monotonic
        counter, the latest directive wins, trainers poll it through the
        ParallelConfig path. Returns the version (starting at 1)."""
        with self._lock:
            self._tuning_version += 1
            version = self._tuning_version
            self._tuning = {
                "version": version,
                "plan_json": plan_json,
                "reason": reason,
            }
        get_tracer().instant("brain.tuning_plan", version=version)
        logger.info(
            "tuning directive v%d (%s)", version, reason or "brain"
        )
        return version

    def get_tuning(self) -> Dict:
        """The latest tuning directive, or ``{"version": 0}``."""
        with self._lock:
            if self._tuning is None:
                return {"version": 0}
            return dict(self._tuning)

    @property
    def worker_num(self) -> int:
        with self._lock:
            return self._num_workers

    # ---- serving reshard (KV-page migration directives) ------------------

    def plan_serving_reshard(
        self,
        victim: str,
        survivors: Optional[List[str]] = None,
        deadline_s: float = 10.0,
        reason: str = "",
    ) -> int:
        """Issue a serving-reshard directive: migrate the victim
        replica's held KV pages onto the survivors within the deadline
        (degrading to re-prefill past it). ``survivors`` defaults to the
        other running serving replicas of the victim's pool when it
        registered with a prefill or decode role (a decode replica's
        pages must land on decode peers), and to the whole fleet
        otherwise. Returns the directive version (monotonic, from 1)."""
        if survivors is None:
            victim_role = next(
                (n.role for n in self.serving_nodes() if n.name == victim),
                "",
            )
            pool = self.serving_nodes(
                victim_role if victim_role in ("prefill", "decode") else None
            )
            survivors = [
                n.name
                for n in pool
                if n.name and n.name != victim and not n.is_exited()
            ]
        with self._lock:
            self._serving_reshard_version += 1
            version = self._serving_reshard_version
            self._serving_reshard = {
                "version": version,
                "victim": victim,
                "survivors": sorted(survivors),
                "deadline_s": float(deadline_s),
                "reason": reason,
            }
        get_tracer().instant(
            "failover.serving_reshard_plan",
            version=version,
            victim=victim,
            survivors=len(survivors),
        )
        logger.info(
            "serving reshard directive v%d: victim=%s survivors=%s (%s)",
            version, victim, sorted(survivors), reason or "eviction",
        )
        return version

    def get_serving_reshard(self) -> Dict:
        """The pending serving directive, or ``{"version": 0}``."""
        with self._lock:
            if self._serving_reshard is None:
                return {"version": 0}
            return dict(self._serving_reshard)

    # ---- serving scale (the serving autoscaler's directives) -------------

    def plan_serving_scale(
        self, role: str, target: int, reason: str = ""
    ) -> int:
        """Version one autoscaler decision: bring the ``role`` pool to
        ``target`` live replicas. The latest directive is kept a role (a
        prefill scale-out never clobbers a pending decode scale-in), the
        versions come from one counter, so the fleet's decision order is
        total. Returns the version (from 1)."""
        with self._lock:
            self._serving_scale_version += 1
            version = self._serving_scale_version
            self._serving_scale[role] = {
                "version": version,
                "role": role,
                "target": int(target),
                "reason": reason,
            }
        get_tracer().instant(
            "serving.scale_plan", version=version, role=role,
            target=int(target),
        )
        logger.info(
            "serving scale directive v%d: role=%s target=%d (%s)",
            version, role, int(target), reason or "slo",
        )
        return version

    def get_serving_scale(self, role: str = "") -> Dict:
        """The latest scale directive for ``role`` or, with no role, the
        newest of all roles; ``{"version": 0}`` when there is none."""
        with self._lock:
            if role:
                d = self._serving_scale.get(role)
                return dict(d) if d else {"version": 0}
            if not self._serving_scale:
                return {"version": 0}
            return dict(max(self._serving_scale.values(),
                            key=lambda d: d["version"]))
