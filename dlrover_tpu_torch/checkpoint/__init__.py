"""Port of ``dlrover_tpu.checkpoint``: Flash Checkpoint in one process."""

from dlrover_tpu_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    StorageType,
)
