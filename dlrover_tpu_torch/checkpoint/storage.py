"""Checkpoint storage: the POSIX implementation, the ``step_N/`` layout,
the ``latest.txt`` tracker and the deletion strategies.

A copy of ``dlrover_tpu/checkpoint/storage.py`` with the same directory
and tracker names, so a checkpoint directory written by either package
reads in the other.
"""

import os
import re
import shutil
from typing import List, Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

STEP_DIR_RE = re.compile(r"^step_(\d+)$")
TRACKER = "latest.txt"


class CheckpointStorage:
    def write_bytes(self, data: memoryview, path: str):
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def makedirs(self, path: str):
        raise NotImplementedError

    def delete(self, path: str):
        raise NotImplementedError


class PosixStorage(CheckpointStorage):
    def write_bytes(self, data: memoryview, path: str):
        """Write through a temporary file, fsync it, then rename, so a
        reader never sees a partial file under ``path``."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def mmap(self, path: str) -> memoryview:
        """The file mapped copy-on-write: a writable buffer, so ``torch``
        views of it need no copy, and nothing written reaches the file."""
        import mmap as mmap_mod

        with open(path, "rb") as f:
            mm = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_COPY)
        return memoryview(mm)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        return os.listdir(path) if os.path.isdir(path) else []

    def makedirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.unlink(path)


class DeletionStrategy:
    def clean_up(self, ckpt_dir: str, storage: CheckpointStorage):
        raise NotImplementedError


class KeepLatestStepStrategy(DeletionStrategy):
    """Keep only the newest N committed step dirs."""

    def __init__(self, max_to_keep: int = 3):
        self.max_to_keep = max_to_keep

    def clean_up(self, ckpt_dir: str, storage: CheckpointStorage):
        latest = read_tracker(ckpt_dir, storage)
        steps = sorted(committed_steps(ckpt_dir, storage))
        for step in steps[: -self.max_to_keep]:
            if step == latest:
                continue  # never delete the tracker's target
            storage.delete(os.path.join(ckpt_dir, f"step_{step}"))
            logger.info("deleted old checkpoint step_%d", step)


class KeepStepIntervalStrategy(DeletionStrategy):
    """Keep steps that are multiples of ``interval``; delete the rest."""

    def __init__(self, interval: int = 1000):
        self.interval = interval

    def clean_up(self, ckpt_dir: str, storage: CheckpointStorage):
        latest = read_tracker(ckpt_dir, storage)
        for step in committed_steps(ckpt_dir, storage):
            if step % self.interval and step != latest:
                storage.delete(os.path.join(ckpt_dir, f"step_{step}"))


def committed_steps(ckpt_dir: str, storage: CheckpointStorage) -> List[int]:
    steps = []
    for name in storage.listdir(ckpt_dir):
        m = STEP_DIR_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return steps


def read_tracker(ckpt_dir: str, storage: CheckpointStorage) -> Optional[int]:
    path = os.path.join(ckpt_dir, TRACKER)
    if not storage.exists(path):
        return None
    try:
        return int(storage.read_bytes(path).decode().strip())
    except (ValueError, OSError):
        return None


def write_tracker(ckpt_dir: str, step: int, storage: CheckpointStorage):
    storage.write_bytes(
        memoryview(str(step).encode()), os.path.join(ckpt_dir, TRACKER)
    )
