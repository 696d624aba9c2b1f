"""Dataset splitters: carve a dataset into dispatchable shards.

A copy of ``dlrover_tpu/master/dataset_splitter.py`` (the same shard
sequence and, for a seed, the same shuffle). Reference: dlrover/python/master/shard/dataset_splitter.py
(Shard:26, TableDatasetSplitter:144, TextDatasetSplitter:257,
StreamingDatasetSplitter:359).
"""

import random
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Shard:
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: List[int] = field(default_factory=list)


class DatasetSplitter:
    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
    ):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = max(1, shard_size)
        self.num_epochs = max(1, num_epochs)
        self.epoch = 0

    def create_shards(self) -> List[Shard]:
        raise NotImplementedError

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs


class TableDatasetSplitter(DatasetSplitter):
    """Contiguous [start, end) ranges over a random-access table."""

    def __init__(self, *args, shuffle: bool = False, seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self.shuffle = shuffle
        self._rng = random.Random(seed)

    def create_shards(self) -> List[Shard]:
        self.epoch += 1
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(name=self.dataset_name, start=start, end=end)
            )
        if self.shuffle:
            self._rng.shuffle(shards)
        return shards


class TextDatasetSplitter(DatasetSplitter):
    """Like Table, but shards carry per-record indices (shuffled lines)."""

    def __init__(self, *args, shuffle: bool = False, seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self.shuffle = shuffle
        self._rng = random.Random(seed)

    def create_shards(self) -> List[Shard]:
        self.epoch += 1
        indices = list(range(self.dataset_size))
        if self.shuffle:
            self._rng.shuffle(indices)
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=start,
                    end=end,
                    record_indices=indices[start:end],
                )
            )
        return shards


class StreamingDatasetSplitter(DatasetSplitter):
    """Unbounded stream: shards are generated on demand from an offset."""

    def __init__(self, *args, max_shard_count: int = 0, **kw):
        super().__init__(*args, **kw)
        self._offset = 0
        self._max_shard_count = max_shard_count
        self._created = 0

    def epoch_finished(self) -> bool:
        return bool(
            self._max_shard_count and self._created >= self._max_shard_count
        )

    def create_shards(self) -> List[Shard]:
        if self.epoch == 0:
            self.epoch = 1
        shards = []
        # emit a window of shards; the task manager calls again when drained
        for _ in range(64):
            if self.epoch_finished():
                break
            shards.append(
                Shard(
                    name=self.dataset_name,
                    start=self._offset,
                    end=self._offset + self.shard_size,
                )
            )
            self._offset += self.shard_size
            self._created += 1
        return shards


def new_dataset_splitter(
    storage_type: str,
    dataset_name: str,
    dataset_size: int,
    shard_size: int,
    num_epochs: int = 1,
    shuffle: bool = False,
    seed: int = 0,
) -> DatasetSplitter:
    if storage_type == "text":
        return TextDatasetSplitter(
            dataset_name,
            dataset_size,
            shard_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            seed=seed,
        )
    if storage_type == "stream":
        return StreamingDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs=num_epochs
        )
    return TableDatasetSplitter(
        dataset_name,
        dataset_size,
        shard_size,
        num_epochs=num_epochs,
        shuffle=shuffle,
        seed=seed,
    )
