"""Elastic data loader with runtime batch-size re-config.

Port of ``dlrover_tpu/elastic/dataloader.py`` (reference:
ElasticDataLoader, dlrover/trainer/torch/elastic/dataloader.py:26): the
batch size reloads at runtime from the parallel-config file
(``DLROVER_TPU_PARAL_CONFIG``, which the agent's ``ParalConfigTuner``
writes, ``agent/config_tuner.py``; the loader reads the file whoever
writes it). It yields host batches, numpy arrays assembled by the user's
``fetch_fn`` over an index source (an ``ElasticDistributedSampler`` or
the master's ``ShardingClient``); placing them on the device is the
train loop's (``Trainer``'s prefetch).
"""

import json
import os
from typing import Callable, Iterator, Optional

import numpy as np

from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class ElasticDataLoader:
    def __init__(
        self,
        fetch_fn: Callable[[np.ndarray], dict],
        sampler=None,
        sharding_client=None,
        batch_size: int = 1,
        config_path: Optional[str] = None,
        drop_last: bool = True,
    ):
        """``fetch_fn(indices) -> batch dict``; exactly one of ``sampler``
        (local indices) / ``sharding_client`` (master shards) drives it."""
        if (sampler is None) == (sharding_client is None):
            raise ValueError(
                "provide exactly one of sampler / sharding_client"
            )
        self.fetch_fn = fetch_fn
        self.sampler = sampler
        self.sharding_client = sharding_client
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.config_path = config_path or os.environ.get(
            GraftEnv.PARAL_CONFIG_PATH, ""
        )
        self._config_version = -1
        self.load_config()

    def load_config(self):
        """Pick up a master-tuned batch size (reference: dataloader.py:97)."""
        if not self.config_path or not os.path.exists(self.config_path):
            return
        try:
            with open(self.config_path) as f:
                cfg = json.load(f)
        except (OSError, ValueError):
            return
        version = cfg.get("version", 0)
        if version == self._config_version:
            return
        self._config_version = version
        bs = cfg.get("batch_size", 0)
        if bs and bs != self.batch_size:
            logger.info(
                "dataloader batch size re-config: %d → %d",
                self.batch_size,
                bs,
            )
            self.batch_size = bs

    def __iter__(self) -> Iterator[dict]:
        self.load_config()
        if self.sampler is not None:
            buf = []
            for idx in self.sampler:
                buf.append(idx)
                if len(buf) == self.batch_size:
                    yield self.fetch_fn(np.asarray(buf))
                    self.sampler.record_batch(self.batch_size)
                    buf = []
                    self.load_config()
            if buf and not self.drop_last:
                yield self.fetch_fn(np.asarray(buf))
                self.sampler.record_batch(len(buf))
        else:
            for start, end, record_indices in self.sharding_client.iter_shards():
                indices = (
                    np.asarray(record_indices)
                    if record_indices
                    else np.arange(start, end)
                )
                for ofs in range(0, len(indices), self.batch_size):
                    chunk = indices[ofs : ofs + self.batch_size]
                    if len(chunk) < self.batch_size and self.drop_last:
                        break
                    yield self.fetch_fn(chunk)
                self.load_config()
