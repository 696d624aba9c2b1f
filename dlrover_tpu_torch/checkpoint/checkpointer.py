"""User-facing Flash Checkpoint API.

Port of ``dlrover_tpu/checkpoint/checkpointer.py``: ``save_checkpoint(step,
state, storage_type=MEMORY|DISK)`` and ``load_checkpoint``, over the
standalone ``CheckpointEngine``. A state is a list of ``core.Leaf``
(``models.convert.train_state_leaves`` makes one of a train state); a
restore writes into the given state in place and returns the restored
step. Peer replication (``replicate=True``) waits for ROADMAP A10's ring.
"""

from typing import Optional, Sequence

from dlrover_tpu_torch.checkpoint.core import Leaf
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.storage import read_tracker


class StorageType:
    MEMORY = "memory"
    DISK = "disk"


class Checkpointer:
    def __init__(self, ckpt_dir: str, storage=None):
        self.ckpt_dir = ckpt_dir
        self.engine = CheckpointEngine(ckpt_dir, storage=storage)

    def save_checkpoint(self, step: int, state: Sequence[Leaf],
                        storage_type: str = StorageType.DISK) -> bool:
        """Stage to memory; DISK also persists on the engine's thread."""
        if storage_type == StorageType.MEMORY:
            return self.engine.save_to_memory(step, state)
        return self.engine.save_to_storage(step, state)

    def load_checkpoint(self, state: Sequence[Leaf],
                        step: Optional[int] = None,
                        partial: bool = False) -> Optional[int]:
        """Restore into ``state`` in place, shared memory first, storage
        after; the restored step, or None when there is no checkpoint.
        ``partial``: leaves missing from the checkpoint keep their values
        (the state-tree-upgrade path; never a params leaf)."""
        return self.engine.load(state, step=step, partial=partial)

    def latest_committed_step(self) -> Optional[int]:
        return read_tracker(self.ckpt_dir, self.engine._storage)

    def wait_for_persist(self, timeout: float = 300.0) -> bool:
        return self.engine.wait_for_persist(timeout)

    def close(self) -> None:
        self.engine.close()
