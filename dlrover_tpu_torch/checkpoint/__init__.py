"""Port of ``dlrover_tpu.checkpoint``: Flash Checkpoint, standalone or
under the node's agent."""

from dlrover_tpu_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    StorageType,
)
