"""Elastic sparse-tier (PS) cluster-version bookkeeping.

Port of ``dlrover_tpu/master/elastic_ps.py`` (reference:
dlrover/python/master/elastic_training/elastic_ps.py:18 ElasticPsService
+ the agent side elastic_agent/tensorflow/elastic_ps.py): the master
keeps a monotonically increasing "cluster version" for the
parameter-server set; when PS membership changes (scale-out/in,
migration) or the Brain installs hot-shard weights, the version bumps
and workers re-partition their key → host assignment (rendezvous
hashing: only the keys owned by the changed hosts migrate). The port
has no sparse tier yet (ROADMAP A18's workers): the master-side service
answers the version calls, which is what a worker of that tier polls.
"""

import threading
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


class ElasticPsService:
    def __init__(self):
        self._lock = threading.Lock()
        self._global_version = 0
        # node_id -> restored/local version (per-worker versions so late
        # joiners can detect they are behind)
        self._node_versions: Dict[int, int] = {}
        self._servers: List[str] = []
        # per-server HRW weights (the Brain's hot-shard rebalance)
        self._weights: Dict[str, float] = {}

    # ---- versions (reference API surface) --------------------------------

    def get_global_version(self) -> int:
        with self._lock:
            return self._global_version

    def bump_global_version(self) -> int:
        with self._lock:
            self._global_version += 1
            logger.info(
                "sparse cluster version → %d", self._global_version
            )
            return self._global_version

    def get_node_version(self, node_id: int) -> int:
        with self._lock:
            return self._node_versions.get(node_id, 0)

    def set_node_version(self, node_id: int, version: int):
        with self._lock:
            self._node_versions[node_id] = version

    # ---- server-set bookkeeping ------------------------------------------

    def get_servers(self) -> List[str]:
        with self._lock:
            return list(self._servers)

    def set_servers(self, servers: List[str]) -> int:
        """Replace the sparse-serving host set; bumps the version when
        membership actually changed."""
        with self._lock:
            if servers == self._servers:
                return self._global_version
            self._servers = list(servers)
            self._global_version += 1
            logger.info(
                "sparse server set changed (%d hosts) → version %d",
                len(servers),
                self._global_version,
            )
            return self._global_version

    def add_server(self, name: str) -> int:
        """Atomically add one server (idempotent). Returns the version.
        Lifecycle callbacks run on the servicer's threads: membership
        edits happen under this lock, or concurrent registrations would
        lose each other's writes."""
        with self._lock:
            if name in self._servers:
                return self._global_version
            self._servers = sorted([*self._servers, name])
            self._global_version += 1
            logger.info(
                "sparse server %s joined (%d hosts) → version %d",
                name, len(self._servers), self._global_version,
            )
            return self._global_version

    def remove_server(self, name: str) -> int:
        """Atomically remove one server (idempotent)."""
        with self._lock:
            if name not in self._servers:
                return self._global_version
            self._servers = [s for s in self._servers if s != name]
            self._global_version += 1
            logger.info(
                "sparse server %s left (%d hosts) → version %d",
                name, len(self._servers), self._global_version,
            )
            return self._global_version

    # ---- HRW weights (the Brain's hot-shard rebalance) --------------------

    def get_weights(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._weights)

    def set_weights(self, weights: Optional[Dict[str, float]]) -> int:
        """Install rebalance weights from a Brain plan
        (``node_resources['ps']['weights']``); bumps the version so
        workers re-partition (changing one server's weight only migrates
        that server's keys)."""
        weights = dict(weights or {})
        with self._lock:
            if weights == self._weights:
                return self._global_version
            self._weights = weights
            self._global_version += 1
            logger.info(
                "sparse HRW weights updated (%d entries) → version %d",
                len(weights),
                self._global_version,
            )
            return self._global_version


class PsClusterCallback:
    """Node lifecycle → sparse server set (reference: dlrover
    node/ps.py scale plans; here membership IS the versioned ring
    workers re-route from). Registered on the JobManager's event
    callbacks: a PS-typed node's start joins the set, its success,
    failure or deletion leaves it; each change bumps the version."""

    def __init__(self, ps_service: ElasticPsService):
        self._ps = ps_service

    def _is_ps(self, node) -> bool:
        return getattr(node, "type", None) == NodeType.PS

    def _name(self, node) -> str:
        return getattr(node, "name", None) or f"ps-{node.id}"

    def on_node_started(self, node, ctx):
        if self._is_ps(node):
            self._ps.add_server(self._name(node))

    def on_node_succeeded(self, node, ctx):
        # an exited PS is not serving regardless of its exit status (a
        # clean drain reports SUCCEEDED, not DELETED)
        self._drop(node)

    def on_node_failed(self, node, ctx):
        self._drop(node)

    def on_node_deleted(self, node, ctx):
        self._drop(node)

    def _drop(self, node):
        if self._is_ps(node):
            self._ps.remove_server(self._name(node))
