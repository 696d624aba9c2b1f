"""Elastic distributed sampler with mid-epoch resume.

Port of ``dlrover_tpu/elastic/sampler.py`` (reference:
ElasticDistributedSampler, dlrover/trainer/torch/elastic/sampler.py:25,
118, 130): a distributed sampler whose ``state_dict``/``load_state_dict``
survive a different world size on resume: the completed samples are
skipped and the rest is partitioned over the new workers. The epoch's
order is numpy's ``RandomState(seed + epoch).permutation``, as in the
JAX package, so the two packages' index streams are the same, element
for element (``tests/test_torch_elastic_data.py``).
"""

from typing import Dict, Iterator, List, Optional

import numpy as np


class ElasticDistributedSampler:
    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas:
            raise ValueError("rank must be < num_replicas")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # samples of this epoch already consumed (across ALL replicas)
        self.completed = 0

    # ---- iteration -------------------------------------------------------

    def _epoch_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            return rng.permutation(self.dataset_size)
        return np.arange(self.dataset_size)

    def __iter__(self) -> Iterator[int]:
        indices = self._epoch_indices()[self.completed :]
        n = len(indices)
        if self.drop_last:
            n = n - (n % self.num_replicas)
            indices = indices[:n]
        else:
            pad = (-n) % self.num_replicas
            if pad and n:
                # tail may hold fewer than ``pad`` indices — tile so every
                # rank still yields the same count (lockstep SPMD needs it)
                reps = -(-pad // n)
                indices = np.concatenate(
                    [indices, np.tile(indices, reps)[:pad]]
                )
        return iter(indices[self.rank :: self.num_replicas].tolist())

    def __len__(self) -> int:
        remaining = self.dataset_size - self.completed
        if self.drop_last:
            return remaining // self.num_replicas
        return (remaining + self.num_replicas - 1) // self.num_replicas

    # ---- elasticity ------------------------------------------------------

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.completed = 0

    def record_batch(self, batch_size_per_replica: int):
        """Advance the consumed counter by one global step."""
        self.completed += batch_size_per_replica * self.num_replicas
        self.completed = min(self.completed, self.dataset_size)

    def state_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "completed": self.completed,
            "seed": self.seed,
            "shuffle": self.shuffle,
            "dataset_size": self.dataset_size,
        }

    def load_state_dict(self, state: Dict):
        """Resume — possibly under a different (num_replicas, rank)."""
        self.epoch = state["epoch"]
        self.completed = int(state["completed"])
        self.seed = state.get("seed", self.seed)
        self.shuffle = state.get("shuffle", self.shuffle)
