"""Node status state machine (reference: master/node/status_flow.py).

Port of ``dlrover_tpu/master/status_flow.py``, unchanged.

Guards against out-of-order platform events (a DELETED watch event arriving
after the pod already FAILED must not resurrect the node, etc.).
"""

from dataclasses import dataclass
from typing import Tuple

from dlrover_tpu_torch.common.constants import NodeStatus

ALLOWED: Tuple[Tuple[str, str], ...] = (
    (NodeStatus.INITIAL, NodeStatus.PENDING),
    (NodeStatus.INITIAL, NodeStatus.RUNNING),
    (NodeStatus.INITIAL, NodeStatus.DELETED),
    (NodeStatus.PENDING, NodeStatus.RUNNING),
    (NodeStatus.PENDING, NodeStatus.FAILED),
    (NodeStatus.PENDING, NodeStatus.DELETED),
    (NodeStatus.PENDING, NodeStatus.SUCCEEDED),
    (NodeStatus.RUNNING, NodeStatus.SUCCEEDED),
    (NodeStatus.RUNNING, NodeStatus.FAILED),
    (NodeStatus.RUNNING, NodeStatus.DELETED),
    (NodeStatus.RUNNING, NodeStatus.CHECK_FAILED),
    (NodeStatus.SUCCEEDED, NodeStatus.DELETED),
    (NodeStatus.FAILED, NodeStatus.DELETED),
    (NodeStatus.CHECK_FAILED, NodeStatus.DELETED),
)


@dataclass
class NodeStateFlow:
    from_status: str
    to_status: str
    allowed: bool


def transition(from_status: str, to_status: str) -> NodeStateFlow:
    if from_status == to_status:
        return NodeStateFlow(from_status, to_status, False)
    return NodeStateFlow(
        from_status, to_status, (from_status, to_status) in ALLOWED
    )
