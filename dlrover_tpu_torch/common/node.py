"""Node model: a host with its local GPUs, participating in a job.

Port of ``dlrover_tpu/common/node.py`` (``NodeResource``, ``Node``)
without the TPU slice topology: a node here is one host, and its agent
spawns one worker process a local GPU.
"""

import copy
import time
from dataclasses import dataclass
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
    NodeType,
)


@dataclass
class NodeResource:
    """Resources of one host (reference: node.py NodeResource)."""

    cpu: float = 0.0
    memory_mb: float = 0.0
    chips: int = 0           # local GPUs
    device_kind: str = ""    # e.g. "NVIDIA H100 80GB HBM3"


class Node:
    """Mutable bookkeeping record of one node (reference: node.py Node)."""

    def __init__(
        self,
        node_type: str = NodeType.WORKER,
        node_id: int = 0,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()

        self.create_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0

        self.exit_reason: str = ""
        self.relaunch_count = 0  # budget-consuming failures only
        self.incarnation = 0     # bumps on EVERY relaunch (pod identity)
        self.agent_restart_count = 0  # agent-reported worker restarts
        self.max_relaunch_count = max_relaunch_count
        self.relaunchable = True
        self.is_released = False
        self.host_addr: str = ""
        # the per-node dataloader config the ParallelConfig poll serves
        # (the servicer folds the job's tuning directive into it)
        self.paral_config: Dict = {}
        # serving nodes: "prefill" | "decode" | "unified" pool tag
        # (empty for train-plane nodes)
        self.role: str = ""

    # ---- status helpers -------------------------------------------------

    def update_status(self, status: str):
        self.status = status
        if status == NodeStatus.RUNNING and self.start_time is None:
            self.start_time = time.time()
        if status in NodeStatus.TERMINAL and self.finish_time is None:
            self.finish_time = time.time()

    def is_exited(self) -> bool:
        return self.status in NodeStatus.TERMINAL

    def should_relaunch(self) -> bool:
        if not self.relaunchable:
            return False
        if self.exit_reason in NodeExitReason.NEVER_RELAUNCH:
            return False
        if self.exit_reason in NodeExitReason.NO_BUDGET:
            return True
        return self.relaunch_count < self.max_relaunch_count

    def inc_relaunch_count(self):
        if self.exit_reason not in NodeExitReason.NO_BUDGET:
            self.relaunch_count += 1

    def new_incarnation(self) -> "Node":
        """Clone bookkeeping for a relaunched incarnation of this node:
        ``incarnation`` always bumps, ``relaunch_count`` only through
        ``inc_relaunch_count``."""
        node = copy.copy(self)
        node.status = NodeStatus.INITIAL
        node.start_time = None
        node.finish_time = None
        node.exit_reason = ""
        node.is_released = False
        node.create_time = time.time()
        node.incarnation = self.incarnation + 1
        return node

    def __repr__(self):
        return (
            f"Node({self.name} status={self.status} rank={self.rank_index} "
            f"relaunch={self.relaunch_count}/{self.max_relaunch_count})"
        )
