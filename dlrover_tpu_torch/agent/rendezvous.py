"""Master-driven rendezvous handler for the torch.distributed bootstrap.

Port of ``dlrover_tpu/agent/rendezvous.py`` (``MasterRendezvousHandler``,
``RendezvousOutcome``; reference: elastic_agent/torch/training.py:179):
join via a master RPC, poll for the sealed world, derive this node's
place in it. The sealed world ``{node_rank: local GPUs}`` yields the
coordinator (host:port of the worker group's store, on the world's
first node), the node's group rank (the JAX ``process_id``) and the
offset of its first worker's global rank, from which the agent derives
each worker's ``RANK`` = offset + ``LOCAL_RANK`` and ``WORLD_SIZE`` =
the world's GPUs.
"""

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import DefaultValues, RendezvousName
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)


class RendezvousTimeoutError(Exception):
    pass


@dataclass
class RendezvousOutcome:
    round: int = 0
    group: int = 0
    # node_rank -> local GPU count, sorted ascending
    world: Dict[int, int] = None
    coordinator: str = ""
    process_id: int = -1       # this node's group rank
    num_processes: int = 0     # nodes in the world
    global_chips: int = 0      # GPUs in the world: the workers' WORLD_SIZE
    rank_offset: int = 0       # global rank of this node's local rank 0


class MasterRendezvousHandler:
    """``coordinator_port`` is called at each join for the store port
    this node offers (0: the master's default)."""

    def __init__(
        self,
        client: MasterClient,
        node_rank: int,
        local_world_size: int,
        rdzv_name: str = RendezvousName.TRAINING,
        timeout_s: float = DefaultValues.RDZV_TIMEOUT_S,
        poll_interval_s: float = 0.5,
        coordinator_port: Optional[Callable[[], int]] = None,
    ):
        self._client = client
        self._node_rank = node_rank
        self._local_world_size = local_world_size
        self._rdzv_name = rdzv_name
        self._timeout_s = timeout_s
        self._poll_interval_s = poll_interval_s
        self._coordinator_port = coordinator_port or (lambda: 0)

    def _join(self) -> int:
        return self._client.join_rendezvous(
            self._local_world_size, rdzv_name=self._rdzv_name,
            coordinator_port=self._coordinator_port(),
        )

    def next_rendezvous(self) -> RendezvousOutcome:
        rdzv_round = self._join()
        get_tracer().instant(
            "failover.rdzv_joined",
            node=self._node_rank,
            rdzv=self._rdzv_name,
            rdzv_round=rdzv_round,
        )
        logger.info(
            "node %d joined %s round %s",
            self._node_rank,
            self._rdzv_name,
            rdzv_round,
        )
        deadline = time.time() + self._timeout_s
        while time.time() < deadline:
            rnd, group, world, coordinator = self._client.get_comm_world(
                rdzv_name=self._rdzv_name
            )
            if world and self._node_rank in world:
                ranks = sorted(world.keys())
                return RendezvousOutcome(
                    round=rnd,
                    group=group,
                    world=world,
                    coordinator=coordinator,
                    process_id=ranks.index(self._node_rank),
                    num_processes=len(ranks),
                    global_chips=sum(world.values()),
                    rank_offset=sum(world[r] for r in ranks
                                    if r < self._node_rank),
                )
            if world and self._node_rank not in world:
                # sealed without us (e.g. max_nodes reached): re-join
                rdzv_round = self._join()
            time.sleep(self._poll_interval_s)
        raise RendezvousTimeoutError(
            f"rendezvous {self._rdzv_name} timed out after {self._timeout_s}s"
        )
