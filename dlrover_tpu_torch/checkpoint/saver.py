"""Persisting a staged pack, and the agent-side async saver daemon.

Port of ``dlrover_tpu/checkpoint/saver.py``: ``persist_pack`` (the
write, then the tracker commit) and ``AsyncCheckpointSaver`` (reference:
elastic_agent/torch/ckpt_saver.py:345-763), a daemon in the agent
process that serves the checkpoint queue, dict and lock to the workers
of its node and persists their staged segments to storage: on a
worker's request (``save_to_storage``), and in an emergency (a worker
died, a restart, SIGTERM) from the agent's own process, so a worker
crash after staging never loses the checkpoint.

The agent serves one lock a worker (``ckpt_<local rank>``) and keeps
each worker's staged pack under ``latest_<local rank>`` in its dict
(the JAX agent has one worker and one ``latest``). It holds a worker's
lock while it reads that worker's segment, as the JAX saver does; the
worker's memory save skips while the lock is held. Two more guards:

- Persists are serialized: an emergency persist that finds the staged
  step already persisted, or being persisted by the daemon's loop,
  waits for that one and writes nothing again.
- The segment must hold a complete pack of the staged step: a worker
  killed mid-stage leaves the header length 0 (it goes in last), and
  the persist then commits nothing newer. The lock of a dead holder is
  released by the broker (``common/multi_process.py``).

The saver also serves the replica ring (``replica.py``) for its
workers: a worker whose ``Checkpointer`` replicates asks for a store
(``{"type": "replica"}``: its rank, the world, ``num_replicas``), which
this process runs, one ``ReplicaManager`` a local rank, and keeps while
the worker's ring slot stays the same; each staged step the worker
then asks to back up (``{"type": "backup"}``) is copied under that
worker's lock and sent to the ring successors from here. So a worker
restart, which every surviving node goes through when a peer node is
lost, keeps the peers' packs this node holds.
"""

import collections
import os
import signal
import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.checkpoint import core
from dlrover_tpu_torch.checkpoint.storage import (
    CheckpointStorage,
    DeletionStrategy,
    PosixStorage,
    write_tracker,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedQueue,
    attach_shared_memory,
    unlink_shared_memory,
)
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)


def meta_key(local_rank: int) -> str:
    """The agent dict's key of a worker's staged pack."""
    return f"latest_{local_rank}"


def lock_name(local_rank: int) -> str:
    """The name of the lock between the agent and one worker."""
    return f"ckpt_{local_rank}"


def persist_pack(
    buf: memoryview,
    ckpt_dir: str,
    step: int,
    process_index: int,
    process_count: int,
    storage: CheckpointStorage,
) -> bool:
    """Write one host's pack and its done marker; commit the tracker when
    every host's marker is there. Returns whether this call committed.

    The protocol of the JAX package: every host writes
    ``step_N/host_i.pack`` then ``step_N/done/host_i.done``; whichever host
    sees the full done set writes ``latest.txt``.
    """
    span = get_tracer().span("ckpt.persist", step=step, nbytes=len(buf))
    with span:
        step_dir = os.path.join(ckpt_dir, f"step_{step}")
        storage.makedirs(step_dir)
        storage.write_bytes(
            buf, os.path.join(step_dir, f"host_{process_index}.pack")
        )
        done_dir = os.path.join(step_dir, "done")
        storage.makedirs(done_dir)
        storage.write_bytes(
            memoryview(b"1"),
            os.path.join(done_dir, f"host_{process_index}.done"),
        )
        done = len(
            [f for f in storage.listdir(done_dir) if f.endswith(".done")]
        )
        committed = done >= process_count
        if committed:
            write_tracker(ckpt_dir, step, storage)
            logger.info("committed checkpoint step %d (%d hosts)", step, done)
    hub = telemetry.get_hub()
    if hub.enabled:
        hub.publish(
            telemetry.CheckpointRecord(
                kind="persist",
                step=step,
                seconds=span.end(),
                nbytes=len(buf),
                tier="storage",
            )
        )
    return committed


class AsyncCheckpointSaver:
    """Singleton daemon owning the checkpoint IPC endpoints in the agent.

    ``timings`` keeps a record of each persist (``wait_s`` for the
    worker's lock, ``seconds`` in all, ``nbytes``, ``committed``, ``by``
    ``"queue"`` or ``"emergency"``, ``at`` on ``time.time``) and of each
    segment found torn."""

    _instance: Optional["AsyncCheckpointSaver"] = None
    _lock = threading.Lock()

    def __init__(self, storage: Optional[CheckpointStorage] = None,
                 local_world_size: int = 1, master_client=None):
        self.storage = storage or PosixStorage()
        self.local_world_size = local_world_size
        # the replica ring's peer discovery (the master's KV store)
        self.master_client = master_client
        self.replicas: Dict[int, object] = {}  # local rank -> ReplicaManager
        self.queue = SharedQueue("ckpt")
        self.meta = SharedDict("ckpt_meta")
        self.shm_locks = [SharedLock(lock_name(i))
                          for i in range(local_world_size)]
        self.deletion_strategy: Optional[DeletionStrategy] = None
        self.timings: collections.deque = collections.deque(maxlen=256)
        self._stop = threading.Event()
        self._persist_mutex = threading.Lock()
        self._last_persisted: Dict[int, int] = {}
        self._thread = threading.Thread(
            target=self._persist_loop, name="ckpt-saver", daemon=True
        )
        self._thread.start()
        self._install_signal_handler()

    # ---- lifecycle -------------------------------------------------------

    @classmethod
    def start_async_saving_ckpt(cls, local_world_size: int = 1,
                                master_client=None
                                ) -> "AsyncCheckpointSaver":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(local_world_size=local_world_size,
                                    master_client=master_client)
        return cls._instance

    def close(self, unlink: bool = False):
        """Stop the daemon, its brokers and replica stores; ``unlink`` also
        removes the workers' staging segments (the job is over)."""
        self._stop.set()
        self._thread.join(5.0)
        for mgr in self.replicas.values():
            mgr.close()
        self.replicas.clear()
        if unlink:
            self.unlink_segments()
        self.queue.close()
        self.meta.close()
        for lock in self.shm_locks:
            lock.close()
        with AsyncCheckpointSaver._lock:
            if AsyncCheckpointSaver._instance is self:
                AsyncCheckpointSaver._instance = None

    def unlink_segments(self) -> int:
        """Remove every staging segment the workers recorded; returns how
        many were removed."""
        n = 0
        for lr in range(self.local_world_size):
            meta = self.meta.get(meta_key(lr))
            if not meta:
                continue
            try:
                unlink_shared_memory(attach_shared_memory(meta["shm"]))
                n += 1
            except FileNotFoundError:
                pass
        return n

    def _install_signal_handler(self):
        if threading.current_thread() is not threading.main_thread():
            return
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            logger.info("SIGTERM: persisting staged checkpoint before exit")
            try:
                self.save_shm_to_storage()
            finally:
                if callable(prev):
                    prev(signum, frame)
                else:  # the default action: exit, through the finally
                    raise SystemExit(128 + signum)  # blocks that clean up

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass

    # ---- persist ---------------------------------------------------------

    def _persist_loop(self):
        while not self._stop.is_set():
            event = self.queue.get(timeout=1.0)
            if not event:
                continue
            kind = event.get("type")
            try:
                if kind == "persist":
                    self._persist_latest(event.get("local_rank"), by="queue")
                elif kind == "replica":
                    self._serve_replica(event)
                elif kind == "backup":
                    self._backup(event)
            except Exception:  # noqa: BLE001
                logger.exception("checkpoint event %s failed", kind)

    # ---- the replica ring -------------------------------------------------

    def _serve_replica(self, event: Dict) -> None:
        """Run (or keep) the store of a worker's ring slot."""
        from dlrover_tpu_torch.checkpoint.replica import (
            ReplicaConfig,
            ReplicaManager,
        )

        lr = event["local_rank"]
        cur = self.replicas.get(lr)
        slot = (event["rank"], event["world"])
        if cur is not None and (cur.process_index,
                                cur.process_count) == slot:
            cur.register()  # the same slot: its held packs stay
            return
        if cur is not None:
            cur.close()
        self.replicas[lr] = ReplicaManager(
            *slot, master_client=self.master_client,
            config=ReplicaConfig(num_replicas=event["num_replicas"],
                                 max_store_bytes=event["max_store_bytes"]))
        logger.info("replica store of rank %d of %d at %s", *slot,
                    self.replicas[lr].addr)

    def _backup(self, event: Dict) -> None:
        """Send a worker's staged pack to its ring successors (on the
        manager's thread; the copy under the worker's lock)."""
        lr = event["local_rank"]
        mgr = self.replicas.get(lr)
        meta = self.meta.get(meta_key(lr))
        if mgr is None or not meta or meta["step"] != event["step"]:
            return  # no store, or a newer staging whose own backup follows
        mgr.backup_async(meta, shm_lock=self.shm_locks[lr])

    def _persist_latest(self, local_rank: Optional[int] = None,
                        by: str = "emergency") -> bool:
        """Persist the staged pack of ``local_rank`` (every worker's when
        None) unless it is persisted already. True if any was written."""
        ranks = (range(self.local_world_size) if local_rank is None
                 else [local_rank])
        with self._persist_mutex:
            wrote = False
            for lr in ranks:
                wrote |= self._persist_rank(lr, by)
            return wrote

    def _persist_rank(self, lr: int, by: str) -> bool:
        """Mutex held."""
        meta = self.meta.get(meta_key(lr))
        if not meta:
            return False
        step = meta["step"]
        if step <= self._last_persisted.get(lr, -1):
            return False
        t0, at = time.perf_counter(), time.time()
        lock = self.shm_locks[lr]
        # lock the worker out of re-staging while we read its segment
        if not lock.acquire(owner="saver"):
            logger.error("persist of step %d: the worker's lock was not "
                         "released within its timeout", step)
            return False
        wait_s = time.perf_counter() - t0
        try:
            shm = attach_shared_memory(meta["shm"])
            buf = memoryview(shm.buf)[: meta["used"]]
            try:
                doc = core.read_header(buf)
                if doc is None or doc["step"] != step:
                    logger.warning(
                        "segment %s holds no complete pack of step %d (a "
                        "worker died mid-stage): nothing committed",
                        meta["shm"], step)
                    self.timings.append({"kind": "torn", "step": step,
                                         "local_rank": lr, "at": at})
                    return False
                committed = persist_pack(
                    buf, meta["dir"], step, meta["process_index"],
                    meta["process_count"], self.storage)
            finally:
                try:
                    buf.release()
                    shm.close()
                except BufferError:  # a view still pins it; GC drops it
                    pass
        finally:
            lock.release(owner="saver")
        self._last_persisted[lr] = step
        logger.info("persisted step %d of local rank %d (%s) in %.3f s, "
                    "%.3f s of it waiting for the worker's lock", step, lr,
                    by, time.perf_counter() - t0, wait_s)
        self.timings.append({
            "kind": "persist", "step": step, "local_rank": lr, "by": by,
            "nbytes": meta["used"], "committed": committed, "at": at,
            "wait_s": wait_s, "seconds": time.perf_counter() - t0})
        if self.deletion_strategy is not None:
            try:
                self.deletion_strategy.clean_up(meta["dir"], self.storage)
            except Exception:  # noqa: BLE001
                logger.warning("checkpoint cleanup failed", exc_info=True)
        return True

    def save_shm_to_storage(self) -> bool:
        """Emergency persist (worker died / SIGTERM / membership change):
        every worker's staged step, unless already persisted (waiting for
        a persist of the daemon's loop in flight)."""
        if self._persist_latest(by="emergency"):
            logger.info("emergency checkpoint persist done")
            return True
        return False
