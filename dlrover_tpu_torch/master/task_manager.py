"""TaskManager: dispatch data shards as tasks; re-queue on failure/timeout.

A copy of ``dlrover_tpu/master/task_manager.py``: the same dispatch
order, the same re-queues and the same dataset checkpoint JSON.
Reference: dlrover/python/master/shard/task_manager.py:37 and
batch_dataset_manager.py:29. This is the dynamic-data-sharding heart: a
worker that dies mid-shard has its in-flight shards re-queued for the
survivors, so elasticity never loses or duplicates data beyond the shard
granularity. Shard checkpoints make dataset position restorable.
"""

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import DefaultValues, TaskType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.dataset_splitter import (
    DatasetSplitter,
    Shard,
    new_dataset_splitter,
)

logger = get_logger(__name__)


@dataclass
class Task:
    task_id: int
    task_type: str
    shard: Shard
    epoch: int = 0
    worker_id: int = -1
    create_time: float = field(default_factory=time.time)
    start_time: float = 0.0

    @classmethod
    def create_invalid_task(cls) -> "Task":
        return cls(task_id=-1, task_type=TaskType.NONE, shard=Shard())


class DatasetManager:
    """Pending/doing task bookkeeping for one dataset."""

    def __init__(self, splitter: DatasetSplitter, task_type: str):
        self.splitter = splitter
        self.task_type = task_type
        self.todo: List[Task] = []
        self.doing: Dict[int, Task] = {}
        self._task_id = 0
        self._completed = 0

    def create_tasks(self):
        if self.splitter.epoch_finished():
            return
        for shard in self.splitter.create_shards():
            self.todo.append(
                Task(
                    task_id=self._task_id,
                    task_type=self.task_type,
                    shard=shard,
                    epoch=self.splitter.epoch,
                )
            )
            self._task_id += 1

    def get_task(self, worker_id: int) -> Task:
        if not self.todo and not self.splitter.epoch_finished():
            self.create_tasks()
        if not self.todo:
            if self.doing:
                # all shards are in flight elsewhere; they may yet be
                # re-queued (worker death / timeout) — tell the worker to
                # wait, not to stop (reference: TaskType.WAIT)
                return Task(
                    task_id=-1, task_type=TaskType.WAIT, shard=Shard()
                )
            return Task.create_invalid_task()
        task = self.todo.pop(0)
        task.worker_id = worker_id
        task.start_time = time.time()
        self.doing[task.task_id] = task
        return task

    def report_task_status(self, task_id: int, success: bool) -> Optional[Task]:
        task = self.doing.pop(task_id, None)
        if task is None:
            return None
        if success:
            self._completed += 1
        else:
            task.worker_id = -1
            task.start_time = 0.0
            self.todo.insert(0, task)
        return task

    def recover_worker_tasks(self, worker_id: int) -> int:
        """Re-queue in-flight tasks of a dead worker."""
        lost = [
            tid for tid, t in self.doing.items() if t.worker_id == worker_id
        ]
        for tid in lost:
            task = self.doing.pop(tid)
            task.worker_id = -1
            self.todo.insert(0, task)
        return len(lost)

    def recover_timeout_tasks(self, timeout_s: float) -> int:
        now = time.time()
        expired = [
            tid
            for tid, t in self.doing.items()
            if t.start_time and now - t.start_time > timeout_s
        ]
        for tid in expired:
            task = self.doing.pop(tid)
            task.worker_id = -1
            self.todo.insert(0, task)
        return len(expired)

    def completed(self) -> bool:
        return (
            self.splitter.epoch_finished()
            and not self.todo
            and not self.doing
        )

    @property
    def completed_count(self) -> int:
        return self._completed

    # ---- checkpoint ------------------------------------------------------

    def checkpoint(self) -> Dict:
        """Undispatched + in-flight shard ranges; restore re-queues both."""
        return {
            "epoch": self.splitter.epoch,
            "todo": [
                [t.shard.start, t.shard.end, t.epoch] for t in self.todo
            ],
            "doing": [
                [t.shard.start, t.shard.end, t.epoch]
                for t in self.doing.values()
            ],
            "splitter_offset": getattr(self.splitter, "_offset", 0),
        }

    def restore_checkpoint(self, ckpt: Dict):
        self.splitter.epoch = ckpt.get("epoch", 0)
        if hasattr(self.splitter, "_offset"):
            self.splitter._offset = ckpt.get("splitter_offset", 0)
        self.todo = []
        self.doing = {}
        name = self.splitter.dataset_name
        for start, end, epoch in ckpt.get("doing", []) + ckpt.get("todo", []):
            self.todo.append(
                Task(
                    task_id=self._task_id,
                    task_type=self.task_type,
                    shard=Shard(name=name, start=start, end=end),
                    epoch=epoch,
                )
            )
            self._task_id += 1


class TaskManager:
    """Cross-dataset task dispatch + periodic timeout re-queue."""

    def __init__(self, shard_timeout_s: float = DefaultValues.SHARD_TIMEOUT_S):
        self._lock = threading.Lock()
        self._datasets: Dict[str, DatasetManager] = {}
        self._shard_timeout_s = shard_timeout_s
        self._worker_last_task: Dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.speed_monitor = None  # wired by the master

    def start(self):
        self._thread = threading.Thread(
            target=self._check_timeout_loop,
            name="task-timeout",
            daemon=True,
        )
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _check_timeout_loop(self):
        while not self._stop.wait(30.0):
            with self._lock:
                for name, ds in self._datasets.items():
                    n = ds.recover_timeout_tasks(self._shard_timeout_s)
                    if n:
                        logger.info(
                            "dataset %s: re-queued %d timed-out shards",
                            name,
                            n,
                        )

    # ---- RPC surface -----------------------------------------------------

    def new_dataset(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "table",
        task_type: str = TaskType.TRAINING,
    ):
        with self._lock:
            if dataset_name in self._datasets:
                return
            splitter = new_dataset_splitter(
                storage_type,
                dataset_name,
                dataset_size,
                shard_size,
                num_epochs=num_epochs,
                shuffle=shuffle,
            )
            ds = DatasetManager(splitter, task_type)
            ds.create_tasks()
            self._datasets[dataset_name] = ds
            logger.info(
                "registered dataset %s size=%d shard=%d epochs=%d",
                dataset_name,
                dataset_size,
                shard_size,
                num_epochs,
            )

    def get_task(self, dataset_name: str, worker_id: int) -> Task:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return Task.create_invalid_task()
            self._worker_last_task[worker_id] = time.time()
            return ds.get_task(worker_id)

    def report_task_status(
        self, dataset_name: str, task_id: int, success: bool, worker_id: int
    ):
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds:
                ds.report_task_status(task_id, success)

    def recover_worker_tasks(self, worker_id: int):
        with self._lock:
            for name, ds in self._datasets.items():
                n = ds.recover_worker_tasks(worker_id)
                if n:
                    logger.info(
                        "dataset %s: re-queued %d shards of dead worker %d",
                        name,
                        n,
                        worker_id,
                    )

    def get_epoch(self, dataset_name: str) -> int:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return ds.splitter.epoch if ds else 0

    def finished(self) -> bool:
        with self._lock:
            if not self._datasets:
                return False
            return all(
                ds.completed()
                for ds in self._datasets.values()
                if ds.task_type == TaskType.TRAINING
            )

    def completed_counts(self) -> Dict[str, int]:
        """Shards reported done, by dataset."""
        with self._lock:
            return {name: ds.completed_count
                    for name, ds in self._datasets.items()}

    def checkpoint(self, dataset_name: str) -> str:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return json.dumps(ds.checkpoint()) if ds else ""

    def restore_checkpoint(self, dataset_name: str, content: str):
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds and content:
                ds.restore_checkpoint(json.loads(content))
