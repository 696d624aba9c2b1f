"""Named barriers across workers (reference: sync_service.py:26).

Port of ``dlrover_tpu/master/sync_service.py``, unchanged.
"""

import threading
from typing import Dict, Set


class SyncService:
    def __init__(self):
        self._lock = threading.Lock()
        self._syncs: Dict[str, Set[int]] = {}
        self._finished: Set[str] = set()
        self._world_size_fn = lambda: 1  # wired by the master

    def set_world_size_fn(self, fn):
        self._world_size_fn = fn

    def join_sync(self, sync_name: str, node_rank: int) -> bool:
        with self._lock:
            members = self._syncs.setdefault(sync_name, set())
            members.add(node_rank)
            if len(members) >= self._world_size_fn():
                self._finished.add(sync_name)
            return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished

    def barrier(self, sync_name: str) -> bool:
        """Explicitly mark a sync finished (master-driven barrier release)."""
        with self._lock:
            self._finished.add(sync_name)
            return True
