"""Master-side rendezvous managers.

Port of ``dlrover_tpu/master/rdzv_manager.py`` (``RendezvousManager``,
``ElasticTrainingRendezvousManager``): nodes join a round, the master
seals min..max of them (in multiples of ``node_unit``) into a world
``{node_rank: local_world_size}`` and hands every member the same world
and coordinator. The coordinator is the host:port of the worker
group's ``torch.distributed`` store, on the first node of the world.

The JAX manager fixes the coordinator's port at 7010. Here the first
node's agent may send the port it picked with its join (the
``DLROVER_TPU_COORDINATOR_PORT`` environment asks for one, 0 for a
free port), so jobs on one host, and a restarted world whose old
listener is still closing, do not collide; a join that sends none gets
the JAX package's 7010. ``NetworkCheckRendezvousManager`` is the JAX
manager's: the nodes paired for the node check's rounds, the faulty
nodes (failing every round) and the stragglers.
``plan_reshard``/``get_reshard_plan`` are the JAX manager's
live-reshard directive, and the round stays sealed for the survivors.
The JAX manager takes the lost dp ranks for node ranks (a host there is
one process); a node here runs ``local_world_size`` ranks, so a node
leaves the sealed world only when every one of its dp ranks is lost.
"""

import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import DefaultValues, RendezvousName
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)


class _WaitingNode:
    def __init__(self, node_id, node_rank, local_world_size, host_addr="",
                 coordinator_port=0):
        self.node_id = node_id
        self.node_rank = node_rank
        self.local_world_size = local_world_size
        self.host_addr = host_addr
        self.coordinator_port = coordinator_port
        self.join_time = time.time()


class RendezvousManager:
    """Assemble a world of {node_rank: local_world_size} per round."""

    def __init__(self, name: str = RendezvousName.TRAINING):
        self.name = name
        self._lock = threading.Lock()
        self._waiting: Dict[int, _WaitingNode] = {}
        self._world: Dict[int, int] = {}
        self._world_coordinator: str = ""
        self._rdzv_round = 0
        self._min_nodes = 1
        self._max_nodes = 1
        self._node_unit = 1
        self._waiting_timeout = DefaultValues.RDZV_WAIT_EXTRA_NODES_S
        self._rdzv_timeout = DefaultValues.RDZV_TIMEOUT_S
        self._start_waiting_time = 0.0
        self._coordinator_port = DefaultValues.COORDINATOR_PORT
        self._alive_nodes: set = set()
        self._reshard_version = 0
        self._reshard: Optional[Dict] = None
        # the node rank of each dp rank of the live world, in dp order
        self._dp_nodes: List[int] = []

    # ---- config ---------------------------------------------------------

    def update_rdzv_params(
        self,
        min_nodes: Optional[int] = None,
        max_nodes: Optional[int] = None,
        waiting_timeout: Optional[float] = None,
        node_unit: Optional[int] = None,
        rdzv_timeout: Optional[float] = None,
    ):
        """Partial update: None keeps the current value."""
        with self._lock:
            if min_nodes is not None:
                self._min_nodes = min_nodes
            if max_nodes is not None:
                self._max_nodes = max_nodes
            if waiting_timeout is not None:
                self._waiting_timeout = waiting_timeout
            if node_unit is not None:
                self._node_unit = max(1, node_unit)
            if rdzv_timeout is not None:
                self._rdzv_timeout = rdzv_timeout

    def add_alive_node(self, node_rank: int):
        with self._lock:
            self._alive_nodes.add(node_rank)

    def remove_alive_node(self, node_rank: int):
        """A node died: drop it and force a new round if it was in-world.

        Exception: when a pending live-reshard directive already lost
        every dp rank of this node, the survivors are migrating state in
        place — the node is out of the sealed world already and the round
        is not torn down (the whole point of the live path is not to
        restart)."""
        with self._lock:
            self._alive_nodes.discard(node_rank)
            self._waiting.pop(node_rank, None)
            directive = self._reshard
            if (directive is not None
                    and node_rank in directive["lost_nodes"]):
                logger.info(
                    "%s: node %s left after reshard directive v%d; "
                    "survivors keep round %d",
                    self.name,
                    node_rank,
                    directive["version"],
                    self._rdzv_round,
                )
                return
            if node_rank not in self._world:
                return
            logger.info(
                "%s: node %s left the sealed world; next joins start "
                "round %d",
                self.name,
                node_rank,
                self._rdzv_round + 1,
            )
            self._world = {}
            self._world_coordinator = ""

    # ---- live reshard ---------------------------------------------------

    def plan_reshard(
        self,
        lost_dp_ranks: List[int],
        dp_size: int,
        deadline_s: float = 30.0,
        reason: str = "",
    ) -> int:
        """Issue a live-reshard directive: survivors migrate ZeRO-1
        shards to the shrunken dp layout instead of restarting.

        Returns the directive version (monotonic, starts at 1). A node
        of the sealed world whose every dp rank is lost leaves it at
        once (the directive's ``lost_nodes``); the round stays sealed
        for the survivors. The dp ranks are the live world's, each
        node's ``local_world_size`` of them in node-rank order, and
        after a reshard the survivors' in their old order."""
        lost = sorted(set(int(r) for r in lost_dp_ranks))
        with self._lock:
            dp_old = int(dp_size)
            dp_new = dp_old - len(lost)
            if dp_new <= 0:
                raise ValueError(
                    f"reshard would leave no survivors: dp={dp_old}, "
                    f"lost={lost}"
                )
            nodes = (self._dp_nodes if self._world
                     and len(self._dp_nodes) == dp_old else [])
            kept = [n for i, n in enumerate(nodes) if i not in lost]
            lost_nodes = sorted(set(nodes) - set(kept))
            self._reshard_version += 1
            self._reshard = {
                "version": self._reshard_version,
                "rdzv_round": self._rdzv_round,
                "dp_old": dp_old,
                "dp_new": dp_new,
                "lost_ranks": lost,
                "lost_nodes": lost_nodes,
                "deadline_s": float(deadline_s),
                "reason": reason,
            }
            self._dp_nodes = kept
            for n in lost_nodes:
                self._world.pop(n, None)
            get_tracer().instant(
                "failover.reshard_plan",
                rdzv=self.name,
                version=self._reshard_version,
                dp_old=dp_old,
                dp_new=dp_new,
                lost=len(lost),
            )
            logger.info(
                "%s: reshard directive v%d: dp %d -> %d, lost=%s (%s)",
                self.name,
                self._reshard_version,
                dp_old,
                dp_new,
                lost,
                reason or "eviction",
            )
            return self._reshard_version

    def get_reshard_plan(self) -> Dict:
        """The pending directive, or ``{"version": 0}`` when none."""
        with self._lock:
            if self._reshard is None:
                return {"version": 0}
            return dict(self._reshard)

    # ---- join / poll ----------------------------------------------------

    def join_rendezvous(
        self,
        node_id: int,
        node_rank: int,
        local_world_size: int,
        host_addr: str = "",
        coordinator_port: int = 0,
    ) -> int:
        with self._lock:
            if node_rank in self._world:
                # a member of the sealed world re-joining ⇒ it restarted;
                # the old world is stale.
                self._world = {}
                self._world_coordinator = ""
            if not self._waiting:
                self._start_waiting_time = time.time()
                self._rdzv_round += 1
            self._waiting[node_rank] = _WaitingNode(
                node_id, node_rank, local_world_size, host_addr,
                coordinator_port,
            )
            self._alive_nodes.add(node_rank)
            get_tracer().instant(
                "failover.rdzv_join",
                rdzv=self.name,
                node=node_rank,
                rdzv_round=self._rdzv_round,
                waiting=len(self._waiting),
            )
            logger.info(
                "%s round %d: node %s joined (%d waiting, min=%d max=%d)",
                self.name,
                self._rdzv_round,
                node_rank,
                len(self._waiting),
                self._min_nodes,
                self._max_nodes,
            )
            return self._rdzv_round

    def _check_rdzv_completed(self) -> bool:
        """Called with the lock held."""
        n = len(self._waiting)
        if n >= self._max_nodes:
            return True
        waited = time.time() - self._start_waiting_time
        usable = n - (n % self._node_unit)
        if usable >= self._min_nodes and waited >= self._waiting_timeout:
            return True
        return False

    def _seal_world(self):
        """Seal min..max nodes into the world; lock held."""
        ranks = sorted(self._waiting.keys())
        n = len(ranks)
        usable = min(n - (n % self._node_unit), self._max_nodes)
        if usable <= 0:
            return
        chosen = ranks[:usable]
        self._world = {
            r: self._waiting[r].local_world_size for r in chosen
        }
        self._dp_nodes = [r for r in chosen for _ in range(self._world[r])]
        first = self._waiting[chosen[0]]
        host = first.host_addr or "localhost"
        port = first.coordinator_port or self._coordinator_port
        self._world_coordinator = f"{host}:{port}"
        for r in chosen:
            self._waiting.pop(r)
        get_tracer().instant(
            "failover.rdzv_seal",
            rdzv=self.name,
            rdzv_round=self._rdzv_round,
            world_size=len(self._world),
        )
        logger.info(
            "%s round %d sealed: world=%s coordinator=%s",
            self.name,
            self._rdzv_round,
            self._world,
            self._world_coordinator,
        )

    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int], str]:
        """Poll for the sealed world: (round, group, world, coordinator)."""
        with self._lock:
            if not self._world and self._waiting:
                if self._check_rdzv_completed():
                    self._seal_world()
            return (
                self._rdzv_round,
                0,
                dict(self._world),
                self._world_coordinator,
            )

    def num_nodes_waiting(self) -> int:
        with self._lock:
            return len(self._waiting)

    @property
    def rdzv_round(self) -> int:
        with self._lock:
            return self._rdzv_round


class ElasticTrainingRendezvousManager(RendezvousManager):
    def __init__(self):
        super().__init__(RendezvousName.TRAINING)


class NetworkCheckRendezvousManager(RendezvousManager):
    """Pairs nodes for matmul+collective health checks.

    Round 1 pairs (0,1)(2,3)…; round 2 re-pairs (0,n-1)(1,2)(3,4)… so a node
    failing in *both* rounds with different partners is the faulty one
    (reference: rdzv_manager.py:412 _group_nodes, :511 check_fault_node,
    :554 _detect_stragglers).
    """

    def __init__(self):
        super().__init__(RendezvousName.NETWORK_CHECK)
        self._results: Dict[int, Dict[int, float]] = {}  # round → rank → t
        self._success: Dict[int, Dict[int, bool]] = {}
        self._check_round = 0
        self._last_world_size = 0

    def get_comm_world(self, node_rank):
        rdzv_round, _, world, coord = super().get_comm_world(node_rank)
        if world:
            with self._lock:
                self._last_world_size = len(world)
            groups = self._group_nodes(sorted(world.keys()))
            for gi, group in enumerate(groups):
                if node_rank in group:
                    sub = {r: world[r] for r in group}
                    return rdzv_round, gi, sub, coord
        return rdzv_round, 0, world, coord

    def _group_nodes(self, ranks: List[int]) -> List[List[int]]:
        n = len(ranks)
        if n <= 2:
            return [ranks]
        round_idx = self._check_round % 2
        groups = []
        if round_idx == 0:
            for i in range(0, n - 1, 2):
                groups.append([ranks[i], ranks[i + 1]])
            if n % 2:
                groups[-1].append(ranks[-1])
        else:
            # rotate pairing so every node gets a different partner:
            # (first, last), then consecutive pairs of the middle section,
            # any middle leftover joins the last group.
            groups.append([ranks[0], ranks[-1]])
            middle = ranks[1:-1]
            for i in range(0, len(middle) - 1, 2):
                groups.append([middle[i], middle[i + 1]])
            if len(middle) % 2:
                groups[-1].append(middle[-1])
        return [g for g in groups if g]

    def report_network_check_result(
        self, node_rank: int, succeeded: bool, elapsed_time: float
    ):
        with self._lock:
            self._results.setdefault(self._check_round, {})[node_rank] = (
                elapsed_time
            )
            self._success.setdefault(self._check_round, {})[node_rank] = (
                succeeded
            )
            # all members of the sealed world reported → advance the round
            # so the next rendezvous re-pairs with different partners
            expected = self._last_world_size
            if expected and len(
                self._success[self._check_round]
            ) >= expected:
                self._advance_round_locked()

    def _advance_round_locked(self):
        self._check_round += 1
        self._world = {}
        self._world_coordinator = ""

    def next_check_round(self):
        with self._lock:
            self._advance_round_locked()

    def check_fault_node(self) -> Tuple[List[int], int]:
        """Nodes failing every observed round are faulty."""
        with self._lock:
            if not self._success:
                return [], self._check_round
            fault: Optional[set] = None
            for results in self._success.values():
                bad = {r for r, ok in results.items() if not ok}
                fault = bad if fault is None else (fault & bad)
            return sorted(fault or []), self._check_round

    def get_stragglers(
        self, ratio: float = DefaultValues.STRAGGLER_RATIO
    ) -> Tuple[List[int], int]:
        with self._lock:
            latest = self._results.get(self._check_round) or self._results.get(
                self._check_round - 1, {}
            )
            if len(latest) < 2:
                return [], self._check_round
            times = sorted(latest.values())
            median = times[len(times) // 2]
            if median <= 0:
                return [], self._check_round
            return (
                sorted(
                    r for r, t in latest.items() if t / median >= ratio
                ),
                self._check_round,
            )
