"""User-facing Flash Checkpoint API.

Port of ``dlrover_tpu/checkpoint/checkpointer.py``: ``save_checkpoint(step,
state, storage_type=MEMORY|DISK)`` and ``load_checkpoint``, over the
``CheckpointEngine`` (in agent mode when the node's agent serves the
run's checkpoint brokers; ``master_client`` reports each staged step
and pins a memory restore to the cluster's minimum). A state is a list
of ``core.Leaf`` (``models.convert.train_state_leaves`` makes one of a
train state); a restore writes into the given state in place and
returns the restored step.

``replicate=True`` (in a world of more than one process) backs each
staged pack up to the ring peers (``replica.py``) and restores through
them when a node's own staged pack is gone: memory, then a peer's
replica, then storage. It needs the master client (the peers' addresses
ride the master's KV store), as the JAX ``Checkpointer`` does. Under the
agent the peers' packs are held by the agent's process; standalone, by
this one.
"""

from typing import Dict, Optional, Sequence

from dlrover_tpu_torch.checkpoint.core import Leaf
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.storage import read_tracker
from dlrover_tpu_torch.common.multi_process import broker_alive
from dlrover_tpu_torch.train.distributed import process_count, process_index


class StorageType:
    MEMORY = "memory"
    DISK = "disk"


class Checkpointer:
    def __init__(self, ckpt_dir: str, storage=None, master_client=None,
                 replicate: bool = False, replica_config=None):
        self.ckpt_dir = ckpt_dir
        use_agent = broker_alive("queue_ckpt")
        replica = None
        if replicate and process_count() > 1:
            if master_client is None:
                # without the KV store there is no peer discovery: the
                # manager would silently replicate nothing
                raise ValueError(
                    "replicate=True requires a master_client for peer "
                    "discovery; pass one or construct the ReplicaManager "
                    "with an explicit peers map")
            from dlrover_tpu_torch.checkpoint.replica import ReplicaManager

            # under the agent the agent's manager holds the peers' packs;
            # this one only fetches
            replica = ReplicaManager(process_index(), process_count(),
                                     master_client=master_client,
                                     config=replica_config,
                                     serve=not use_agent)
        self.engine = CheckpointEngine(ckpt_dir, storage=storage,
                                       master_client=master_client,
                                       use_agent=use_agent, replica=replica)

    def save_checkpoint(self, step: int, state: Sequence[Leaf],
                        storage_type: str = StorageType.DISK,
                        extra: Optional[Dict] = None) -> bool:
        """Stage to memory; DISK also persists on the engine's thread.
        ``extra`` rides in the pack header (``engine.restored_extra``
        after a restore)."""
        if storage_type == StorageType.MEMORY:
            return self.engine.save_to_memory(step, state, extra)
        return self.engine.save_to_storage(step, state, extra)

    def load_checkpoint(self, state: Sequence[Leaf],
                        step: Optional[int] = None,
                        partial: bool = False,
                        bridge=None) -> Optional[int]:
        """Restore into ``state`` in place, shared memory first, storage
        after; the restored step, or None when there is no checkpoint.
        ``partial``: leaves missing from the checkpoint keep their values
        (the state-tree-upgrade path; never a params leaf). ``bridge``:
        ``core.restore_leaves``'s (``models.convert.moment_bridge`` for a
        train state)."""
        return self.engine.load(state, step=step, partial=partial,
                                bridge=bridge)

    def latest_committed_step(self) -> Optional[int]:
        return read_tracker(self.ckpt_dir, self.engine._storage)

    def wait_for_persist(self, timeout: float = 300.0) -> bool:
        return self.engine.wait_for_persist(timeout)

    def close(self) -> None:
        self.engine.close()
