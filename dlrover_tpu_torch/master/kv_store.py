"""In-master KV store (reference: elastic_training/kv_store_service.py:18).

Port of ``dlrover_tpu/master/kv_store.py``, unchanged: string keys and
values that agents and workers set, read and wait for through the
master (the reference backs its c10d store with it).
"""

import threading
import time
from typing import Dict, Optional


class KVStoreService:
    def __init__(self):
        self._lock = threading.Lock()
        self._store: Dict[str, str] = {}
        self._cond = threading.Condition(self._lock)

    def set(self, key: str, value: str):
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str) -> str:
        with self._lock:
            return self._store.get(key, "")

    def add(self, key: str, delta: int = 1) -> int:
        with self._cond:
            val = int(self._store.get(key, "0")) + delta
            self._store[key] = str(val)
            self._cond.notify_all()
            return val

    def wait(self, key: str, timeout_s: float = 60.0) -> Optional[str]:
        deadline = time.time() + timeout_s
        with self._cond:
            while key not in self._store:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._store[key]

    def delete(self, key: str):
        with self._lock:
            self._store.pop(key, None)

    def clear(self):
        with self._lock:
            self._store.clear()
