"""Singleton runtime configuration (reference: common/global_context.py).

Port of ``dlrover_tpu/common/global_context.py``: every tunable the
master and the agent read has a ``DefaultValues`` default and may be
overridden from the environment (``DLROVER_TPU_CTX_<NAME>=value``).
"""

import os
import threading

from dlrover_tpu_torch.common.constants import DefaultValues


class Context:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.master_service_port = DefaultValues.SERVICE_PORT
        self.rpc_timeout_s = DefaultValues.RPC_TIMEOUT_S
        self.rpc_retry = DefaultValues.RPC_RETRY
        self.heartbeat_interval_s = DefaultValues.HEARTBEAT_INTERVAL_S
        self.heartbeat_timeout_s = DefaultValues.HEARTBEAT_TIMEOUT_S
        self.supervise_interval_s = DefaultValues.SUPERVISE_INTERVAL_S
        self.rdzv_timeout_s = DefaultValues.RDZV_TIMEOUT_S
        self.rdzv_wait_extra_nodes_s = DefaultValues.RDZV_WAIT_EXTRA_NODES_S
        self.relaunch_budget = DefaultValues.RELAUNCH_BUDGET
        self.pending_timeout_s = DefaultValues.PENDING_TIMEOUT_S
        self.straggler_ratio = DefaultValues.STRAGGLER_RATIO
        self.shard_timeout_s = DefaultValues.SHARD_TIMEOUT_S
        self.hang_kick_cooldown_s = DefaultValues.HANG_KICK_COOLDOWN_S
        self.autoscale_interval_s = DefaultValues.AUTOSCALE_INTERVAL_S
        self._load_env_overrides()

    def _load_env_overrides(self):
        """`DLROVER_TPU_CTX_<NAME>=value` overrides attribute `<name>`."""
        prefix = "DLROVER_TPU_CTX_"
        for key, value in os.environ.items():
            if not key.startswith(prefix):
                continue
            attr = key[len(prefix):].lower()
            if hasattr(self, attr):
                cur = getattr(self, attr)
                cast = type(cur) if cur is not None else str
                try:
                    setattr(self, attr, cast(value))
                except (TypeError, ValueError):
                    setattr(self, attr, value)

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance


def get_context() -> Context:
    return Context.singleton_instance()
