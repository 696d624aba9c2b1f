"""The elastic example's worker with the node-loss drill's planted
variants, for ``tests/test_torch_node_loss.py``:

- ``NODE_LOSS_STAGE_EXTRA=1``: the rank that loses its node first stages
  the step it ran past the saved one (the others do not), so a ring
  holder holds a newer step of it than the cluster's minimum staged step;
- ``NODE_LOSS_NO_PIN=1``: the replica tier skips the master's minimum
  staged step (the fault the drill must catch).

Run it as the example: ``python tests/torch_node_loss_worker.py
<the example's arguments>``.
"""

import os
import sys

from dlrover_tpu_torch.checkpoint import StorageType
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.examples import train_gpt_elastic as ex

if os.environ.get("NODE_LOSS_STAGE_EXTRA") == "1":
    _lose_node = ex.lose_node

    def _stage_then_lose(trainer, args, rank, step):
        assert trainer.checkpointer.save_checkpoint(
            step, trainer.state_leaves(), StorageType.MEMORY,
            extra=trainer._ckpt_extra())
        args.lose_node_at = step  # the holders must hold it first
        _lose_node(trainer, args, rank, step)

    ex.lose_node = _stage_then_lose

if os.environ.get("NODE_LOSS_NO_PIN") == "1":
    _from_replica = CheckpointEngine._load_from_replica

    def _unpinned(self, *args, **kwargs):
        client, self._client = self._client, None
        try:
            return _from_replica(self, *args, **kwargs)
        finally:
            self._client = client

    CheckpointEngine._load_from_replica = _unpinned

if __name__ == "__main__":
    sys.exit(ex.main())
