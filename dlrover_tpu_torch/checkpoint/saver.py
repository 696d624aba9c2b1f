"""Persisting a staged pack: the write, then the tracker commit.

Port of ``persist_pack`` from ``dlrover_tpu/checkpoint/saver.py``. The
agent-side ``AsyncCheckpointSaver`` daemon, which persists the worker's
segment from the agent process, waits for the agent (ROADMAP A8); the
standalone engine runs ``persist_pack`` on a thread of its own.
"""

import os

from dlrover_tpu_torch.checkpoint.storage import (
    CheckpointStorage,
    write_tracker,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)


def persist_pack(
    buf: memoryview,
    ckpt_dir: str,
    step: int,
    process_index: int,
    process_count: int,
    storage: CheckpointStorage,
) -> bool:
    """Write one host's pack and its done marker; commit the tracker when
    every host's marker is there. Returns whether this call committed.

    The protocol of the JAX package: every host writes
    ``step_N/host_i.pack`` then ``step_N/done/host_i.done``; whichever host
    sees the full done set writes ``latest.txt``.
    """
    span = get_tracer().span("ckpt.persist", step=step, nbytes=len(buf))
    with span:
        step_dir = os.path.join(ckpt_dir, f"step_{step}")
        storage.makedirs(step_dir)
        storage.write_bytes(
            buf, os.path.join(step_dir, f"host_{process_index}.pack")
        )
        done_dir = os.path.join(step_dir, "done")
        storage.makedirs(done_dir)
        storage.write_bytes(
            memoryview(b"1"),
            os.path.join(done_dir, f"host_{process_index}.done"),
        )
        done = len(
            [f for f in storage.listdir(done_dir) if f.endswith(".done")]
        )
        committed = done >= process_count
        if committed:
            write_tracker(ckpt_dir, step, storage)
            logger.info("committed checkpoint step %d (%d hosts)", step, done)
    hub = telemetry.get_hub()
    if hub.enabled:
        hub.publish(
            telemetry.CheckpointRecord(
                kind="persist",
                step=step,
                seconds=span.end(),
                nbytes=len(buf),
                tier="storage",
            )
        )
    return committed
