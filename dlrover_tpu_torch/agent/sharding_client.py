"""Worker-side dynamic data sharding client.

Port of ``dlrover_tpu/agent/sharding_client.py`` (reference:
dlrover/python/elastic_agent/sharding/client.py:29, ShardingClient /
IndexShardingClient): fetch shard tasks from the master's TaskManager,
report completion, checkpoint/restore the dataset position.

One difference: the JAX client holds one current task, so a second
fetch before the first shard is reported forgets the first. Here the
fetched tasks wait in a queue, oldest first, and ``report_shard_done``
and ``report_batch_done`` close the oldest. A loop that fetches ahead of
its step (batches prefetched to the card) reports each shard when the
step that trained it has run, and the master's dataset checkpoint then
holds the fetched but untrained shards as in flight, which a restore
re-queues first.
"""

import collections
import threading
import time
from typing import Iterator, List, Optional, Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class ShardingClient:
    def __init__(
        self,
        client: MasterClient,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "table",
    ):
        self._client = client
        self.dataset_name = dataset_name
        self._lock = threading.Lock()
        self._in_flight: collections.deque = collections.deque()
        self._consumed = 0
        client.report_dataset_shard_params(
            dataset_name,
            dataset_size,
            shard_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            storage_type=storage_type,
        )

    def fetch_shard(
        self, poll_interval_s: float = 2.0
    ) -> Optional[Tuple[int, int, List[int]]]:
        """Next (start, end, record_indices); None when the dataset is done.

        A WAIT task (all shards in flight on other workers) polls — those
        shards may be re-queued if their worker dies.
        """
        while True:
            task = self._client.get_task(self.dataset_name)
            if task.task_type == TaskType.WAIT:
                time.sleep(poll_interval_s)
                continue
            if task.task_id < 0:
                return None
            with self._lock:
                self._in_flight.append(task)
            return task.shard_start, task.shard_end, task.record_indices

    def report_shard_done(self, success: bool = True
                          ) -> Optional[Tuple[int, int]]:
        """Report the oldest fetched shard (done, or failed: re-queued);
        its (start, end), None when none was in flight."""
        with self._lock:
            if not self._in_flight:
                return None
            self._consumed = 0
            task = self._in_flight.popleft()
        self._client.report_task_result(
            self.dataset_name, task.task_id, success=success
        )
        return task.shard_start, task.shard_end

    def report_batch_done(self, batch_size: int) -> bool:
        """Count consumed records against the oldest fetched shard; report
        the shard done when fully consumed.  Reference:
        IndexShardingClient.report_batch_done (sharding/client.py) —
        the per-step accounting the ElasticDataShardReportHook drives.
        Returns True when this call closed the shard."""
        with self._lock:
            if not self._in_flight:
                return False
            task = self._in_flight[0]
            self._consumed += int(batch_size)
            done = self._consumed >= (task.shard_end - task.shard_start)
            if done:
                # pop under THIS lock: a concurrent fetch_shard appends
                # behind it, and a later report must close that one
                self._in_flight.popleft()
                self._consumed = 0
        if done:
            self._client.report_task_result(
                self.dataset_name, task.task_id, success=True
            )
        return done

    def iter_shards(self) -> Iterator[Tuple[int, int, List[int]]]:
        while True:
            shard = self.fetch_shard()
            if shard is None:
                return
            yield shard
            self.report_shard_done()

    # ---- dataset-position checkpoint ------------------------------------

    def checkpoint(self) -> str:
        return self._client.get_shard_checkpoint(self.dataset_name)

    def restore(self, content: str) -> bool:
        """Put the master's dataset back to ``content`` (from
        ``checkpoint``); this client's fetched shards are forgotten."""
        with self._lock:
            self._in_flight.clear()
            self._consumed = 0
        return self._client.report_shard_checkpoint(
            self.dataset_name, content
        )

    def get_epoch(self) -> int:
        return self._client.get_dataset_epoch(self.dataset_name)
