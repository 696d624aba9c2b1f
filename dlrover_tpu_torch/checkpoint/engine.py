"""Worker-side checkpoint engine: device → host shared memory, async persist.

Port of ``CheckpointEngine`` of ``dlrover_tpu/checkpoint/engine.py``:
the worker blocks only for the copy of its state into a named POSIX
segment; the segment is persisted to storage, and the tracker committed,
off the worker's path. Restore reads the segment when it holds a
complete pack of this checkpoint directory, else a ring peer's copy
(the replica tier, ``replica.py``, when the engine has a
``ReplicaManager``), else the committed storage.

Two modes, detected as the JAX engine detects them (``use_agent``: a
live agent broker serves the run's checkpoint queue):

- **Agent mode.** The agent's ``AsyncCheckpointSaver`` serves a queue,
  a dict and a lock a worker. A save stages the segment under the
  agent's lock (skipped while the agent holds it, reading the segment),
  records the staged pack in the agent's dict and reports the step to
  the master. A disk save first waits for the agent's persist in flight
  (its lock), then stages and asks the agent to persist. The agent
  persists from its own process, and again after a worker crash, so a
  staged pack outlives the worker. A memory restore takes the pack the
  agent's dict names, and only at the master's minimum staged step
  (``get_min_ckpt_step``), so every rank resumes the same step. This is
  the JAX package's own discipline, but for the disk save's wait: the
  JAX engine skips a disk save while the agent persists, so a job's
  final save could be lost (ROADMAP C).
- **Standalone.** A thread of the engine persists, as below.

In both, the pack's process is the worker's global rank of the world
(``torch.distributed``), and each rank stages its own segment
(``shm_name(rank)``). Two things of the standalone mode differ from the
JAX engine, each for a reason:

- The standalone persist holds the engine's lock while it reads the
  segment, as the JAX agent's saver does (``saver.py`` of the JAX
  package); a memory save skips while the lock is held, so a staged
  pack is never overwritten while it is being persisted. A disk save
  first waits for the previous persist, then stages, and hands the lock
  to its own persist.
- The segment is found by name, and its pack by its own header (the
  length written last), so a new engine in the same or a restarted
  process restores from memory; that engine adopts the segment for its
  own saves.

On the card the segment is registered with CUDA (page-locked) once per
engine, when it creates or adopts it: copies to and from pageable
memory run at a fraction of the bus's rate, and a fresh mapping's
first touch of each page faults.

The replica tier (the JAX engine's): each staged step is backed up to
the ring successors, off the worker's path. Standalone, the engine's
own manager copies the segment under the engine's lock on a thread;
under the agent, the engine asks the agent to (``{"type": "backup"}``
on the checkpoint queue), whose manager holds the peers' packs across
worker restarts. Either copy reads the segment only after the staging
that wrote it has released the lock, and ``core.write_pack`` waits for
its card copies before it writes the header length, so a backup never
reads a pack whose card copies are in flight. A restore that finds no
staged pack of its own fetches it from a holder, pinned to the
master's minimum staged step (``get_min_ckpt_step``), trying the next
holder when a pack fails to restore.
"""

import collections
import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from dlrover_tpu_torch.checkpoint import core
from dlrover_tpu_torch.checkpoint.saver import (
    lock_name,
    meta_key,
    persist_pack,
)
from dlrover_tpu_torch.checkpoint.storage import PosixStorage, read_tracker
from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDictClient,
    SharedLockClient,
    SharedQueueClient,
    attach_shared_memory,
    broker_alive,
    create_shared_memory,
    unlink_shared_memory,
)
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.train.distributed import process_count, process_index

logger = get_logger(__name__)

SHM_DIR = "/dev/shm"
# how long a disk save under the agent waits for the persist in flight
PERSIST_WAIT_S = 300.0


def shm_name(process_index: int = 0, run_id: Optional[str] = None) -> str:
    """The staging segment's name: one per run (``run_id``, by default
    ``DLROVER_TPU_RUN_ID``) and process."""
    run_id = run_id or os.environ.get(GraftEnv.RUN_ID, "default")
    return f"dlrover_tpu_torch_ckpt_{run_id}_{process_index}"


def _round_up(n: int, unit: int = 1 << 20) -> int:
    return (n + unit - 1) // unit * unit


def _check_room(name: str, size: int) -> None:
    """Raise unless /dev/shm can hold a segment of ``size`` bytes in
    place of ``name``'s: writing past the room of a POSIX segment kills
    the process with SIGBUS instead of raising."""
    try:
        have = os.stat(os.path.join(SHM_DIR, name)).st_size
    except FileNotFoundError:
        have = 0
    st = os.statvfs(SHM_DIR)
    free = st.f_bavail * st.f_frsize + have
    if free < size:
        raise RuntimeError(
            f"{SHM_DIR} has {free} bytes free for the checkpoint segment "
            f"{name}, which needs {size} bytes; enlarge {SHM_DIR} or stage "
            "less state")


def _cuda_register(buf: torch.Tensor) -> None:
    err = torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), buf.numel(),
                                               0)
    if int(getattr(err, "value", err)) != 0:
        raise RuntimeError(f"cudaHostRegister of the checkpoint segment "
                           f"({buf.numel()} bytes) failed: {err}")


def _cuda_unregister(buf: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())


class CheckpointEngine:
    """Stages a state (a list of ``core.Leaf``) into shared memory and
    persists it on a thread; restores memory first, then storage.

    ``timings`` keeps the last records of each save (``register_s``,
    ``copy_s``, ``wait_s`` and the blocking ``seconds``), persist and
    restore (its ``register_s`` within its ``seconds``), with their
    bytes; ``at`` is each one's start on ``time.perf_counter``."""

    def __init__(self, ckpt_dir: str, storage=None, master_client=None,
                 use_agent: Optional[bool] = None, replica=None):
        """``replica``: a ``replica.ReplicaManager`` (the worker's own when
        standalone; under the agent a ``serve=False`` one, for fetches)."""
        self.ckpt_dir = ckpt_dir
        self._replica = replica
        # called on each pack the replica tier restores; its result goes
        # in the restore's timing record (``digest``)
        self.replica_digest: Optional[Callable[[memoryview], str]] = None
        self._client = master_client
        self._storage = storage or PosixStorage()
        if use_agent is None:
            use_agent = broker_alive("queue_ckpt")
        self._use_agent = use_agent
        self.local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        if use_agent:
            self._queue = SharedQueueClient("ckpt")
            self._agent_meta = SharedDictClient("ckpt_meta")
            self._agent_lock = SharedLockClient(lock_name(self.local_rank))
            if replica is not None:
                # the agent's manager holds the peers' packs for this rank
                self._queue.put({"type": "replica",
                                 "local_rank": self.local_rank,
                                 "rank": replica.process_index,
                                 "world": replica.process_count,
                                 "num_replicas": replica.config.num_replicas,
                                 "max_store_bytes":
                                     replica.config.max_store_bytes})
        self._shm = None
        self._buf: Optional[torch.Tensor] = None  # uint8 over the segment
        self._registered = False
        self.register_seconds = 0.0
        self._local_step = -1
        self._latest: Optional[Dict] = None  # the staged pack's meta
        # the restored pack's header ``extra`` (its dir and what the saver
        # added to it)
        self.restored_extra: Dict = {}
        # the process group whose ranks write a step's packs (the world;
        # after a live reshard, the survivors')
        self.group = None
        self._lock = threading.Lock()
        self._persist_thread: Optional[threading.Thread] = None
        self._persist_error: Optional[BaseException] = None
        self.timings: collections.deque = collections.deque(maxlen=256)

    @property
    def use_agent(self) -> bool:
        return self._use_agent

    @property
    def replica(self):
        """The engine's ``ReplicaManager``, or None."""
        return self._replica

    @property
    def process_index(self) -> int:
        """This worker's rank in ``group`` (0 outside a process group)."""
        return process_index(self.group)

    @property
    def process_count(self) -> int:
        return process_count(self.group)

    def _acquire(self, timeout: Optional[float] = None) -> bool:
        """Take the segment's lock: at once, or within ``timeout``."""
        blocking = timeout is not None
        if self._use_agent:
            return self._agent_lock.acquire(blocking=blocking,
                                            timeout=timeout or 0.0)
        return self._lock.acquire(blocking=blocking,
                                  timeout=timeout if blocking else -1)

    def _release(self) -> None:
        if self._use_agent:
            self._agent_lock.release()
        else:
            self._lock.release()

    # ---- save ------------------------------------------------------------

    def save_to_memory(self, step: int, leaves: Sequence[core.Leaf],
                       extra: Optional[Dict] = None) -> bool:
        """Stage ``leaves`` into shared memory. Returns False if skipped
        (a persist is reading the segment). ``extra``: more fields of the
        pack header's ``extra`` (a dataset position), given back by a
        restore as ``restored_extra``."""
        return self._stage(step, leaves, "save_memory", 0.0, hold=False,
                           extra=extra)

    def save_to_storage(self, step: int, leaves: Sequence[core.Leaf],
                        extra: Optional[Dict] = None) -> bool:
        """Wait for the previous persist, stage, and persist: on a thread
        (standalone), or from the agent's process (agent mode), whose
        persist is waited for by its lock, at most ``PERSIST_WAIT_S``.
        Returns False if that wait ran out."""
        if self._use_agent:
            if not self._stage(step, leaves, "save_storage", 0.0, hold=False,
                               lock_timeout=PERSIST_WAIT_S, extra=extra):
                return False
            return self._queue.put({"type": "persist", "step": step,
                                    "local_rank": self.local_rank})
        t0 = time.perf_counter()
        self._join_persist()
        wait_s = time.perf_counter() - t0
        if not self._stage(step, leaves, "save_storage", wait_s, hold=True,
                           extra=extra):
            return False
        meta = dict(self._latest)
        self._persist_thread = threading.Thread(
            target=self._persist_standalone, args=(meta,), daemon=True,
            name="ckpt-persist")
        self._persist_thread.start()
        return True

    def _stage(self, step, leaves, kind, wait_s, hold,
               lock_timeout: Optional[float] = None,
               extra: Optional[Dict] = None) -> bool:
        """Stage under the lock, taken at once or within ``lock_timeout``;
        with ``hold`` (standalone) the lock stays held for the caller's
        persist, which releases it."""
        t0 = time.perf_counter()
        entries, payload = core.plan_pack(leaves)
        rank, world = self.process_index, self.process_count
        header = core.header_bytes(step, entries,
                                   dict(extra or {}, dir=self.ckpt_dir),
                                   rank, world)
        total = core.pack_size(header, payload)
        t_lock = time.perf_counter()
        if not self._acquire(lock_timeout):
            if lock_timeout is None:
                logger.warning("step %d: a persist is reading the segment, "
                               "skipping the memory save", step)
            else:
                logger.error("step %d: the persist in flight did not end "
                             "within %.0fs; the disk save is NOT made",
                             step, lock_timeout)
            self.timings.append({"kind": "skipped", "step": step})
            return False
        lock_wait_s = time.perf_counter() - t_lock
        span = get_tracer().span("ckpt.save_memory", step=step, nbytes=total)
        staged = False
        try:
            on_card = any(s.tensor.is_cuda for leaf in leaves
                          for s in leaf.shards)
            t_reg = time.perf_counter()
            self._ensure_segment(total, on_card)
            t_copy = time.perf_counter()
            used = core.write_pack(self._buf, leaves, entries, header)
            t_end = time.perf_counter()
            self._latest = {
                "step": step, "used": used, "dir": self.ckpt_dir,
                "shm": self._shm.name, "process_index": rank,
                "process_count": world, "time": time.time(),
            }
            if self._use_agent:
                self._agent_meta.set(meta_key(self.local_rank), self._latest)
            self._local_step = step
            staged = True
        finally:
            if not (staged and hold):
                self._release()
            span.end()
        rec = {"kind": kind, "step": step, "nbytes": total, "at": t0,
               "register_s": t_copy - t_reg, "copy_s": t_end - t_copy,
               "wait_s": wait_s + lock_wait_s,
               "seconds": wait_s + t_end - t0}
        self.timings.append(rec)
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(telemetry.CheckpointRecord(
                kind="save_memory", step=step, seconds=rec["seconds"],
                nbytes=total, tier="memory"))
        if self._replica is not None:
            self._backup(step)
        if self._client is not None:
            try:
                self._client.report_ckpt_step(step, rank=rank)
            except Exception:  # noqa: BLE001
                logger.warning("ckpt step report failed", exc_info=True)
        logger.info("staged step %d to shm in %.3fs (%.1f MB)", step,
                    rec["seconds"], total / 1e6)
        return True

    def _backup(self, step: int) -> None:
        """Stream the staged pack to the ring peers, off the worker's path:
        the agent's manager does it under the agent; standalone, this
        engine's, once the staging (or the persist it handed the lock to)
        has released the lock."""
        if self._use_agent:
            self._queue.put({"type": "backup", "step": step,
                             "local_rank": self.local_rank})
        else:
            self._replica.backup_async(dict(self._latest),
                                       shm_lock=self._lock)

    def _ensure_segment(self, total: int, on_card: bool) -> None:
        if self._shm is None or self._shm.size < total:
            self._close_segment()
            name = shm_name(self.process_index)
            size = _round_up(total)
            _check_room(name, size)
            self._adopt(create_shared_memory(name, size))
        if on_card:
            self._register()

    def _adopt(self, shm) -> None:
        self._shm = shm
        self._buf = torch.frombuffer(shm.buf, dtype=torch.uint8)

    def _register(self) -> None:
        """Page-lock the segment for the card, once; its seconds add to
        ``register_seconds``."""
        if not self._registered:
            t0 = time.perf_counter()
            _cuda_register(self._buf)
            self._registered = True
            self.register_seconds += time.perf_counter() - t0

    def _close_segment(self) -> None:
        if self._shm is None:
            return
        if self._registered:
            _cuda_unregister(self._buf)
            self._registered = False
        self._buf = None
        try:
            self._shm.close()
        except BufferError:  # a view still pins the mapping; GC drops it
            pass
        self._shm = None

    def _persist_standalone(self, meta):
        """The persist thread: holds the lock the staging handed it."""
        t0 = time.perf_counter()
        try:
            persist_pack(memoryview(self._shm.buf)[: meta["used"]],
                         meta["dir"], meta["step"], meta["process_index"],
                         meta["process_count"], self._storage)
            self.timings.append({"kind": "persist", "step": meta["step"],
                                 "nbytes": meta["used"], "at": t0,
                                 "seconds": time.perf_counter() - t0})
        except BaseException as e:  # noqa: BLE001 — re-raised by the waiter
            self._persist_error = e
            logger.exception("persist of step %d failed", meta["step"])
        finally:
            self._lock.release()

    def _join_persist(self, timeout: Optional[float] = None) -> bool:
        t = self._persist_thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                return False
        if self._persist_error is not None:
            err, self._persist_error = self._persist_error, None
            raise RuntimeError("the previous checkpoint persist failed") \
                from err
        return True

    def _wait_for_tracker(self, timeout: float) -> bool:
        """Agent mode: the agent commits; wait for the tracker to name
        the latest staged step."""
        deadline = time.time() + timeout
        while read_tracker(self.ckpt_dir, self._storage) != self._local_step:
            if time.time() >= deadline:
                return False
            time.sleep(0.1)
        return True

    def wait_for_persist(self, timeout: float = 300.0) -> bool:
        """Block until the latest staged step is committed to storage.
        Returns False, and publishes a failed ``persist_wait`` record, when
        the commit does not land inside ``timeout``; raises when the
        standalone persist failed."""
        if self._use_agent:
            ok = self._wait_for_tracker(timeout)
        else:
            ok = self._join_persist(timeout)
        if not ok:
            logger.error(
                "persist of step %d did not commit within %.0fs; the "
                "storage tier is STALE for this step", self._local_step,
                timeout)
            hub = telemetry.get_hub()
            if hub.enabled:
                hub.publish(telemetry.CheckpointRecord(
                    kind="persist_wait", step=self._local_step,
                    seconds=timeout, ok=False, tier="storage"))
        return ok

    def close(self) -> None:
        """Wait for the persist (and the replica backup), then release the
        segment (it stays in /dev/shm for a later restore;
        ``unlink_segment`` removes it)."""
        self._join_persist()
        if self._replica is not None:
            self._replica.close()
        self._close_segment()

    @staticmethod
    def unlink_segment(process_index: int = 0,
                       run_id: Optional[str] = None) -> bool:
        """Remove the staging segment of ``process_index`` in this run (or
        in ``run_id``'s); False if there was none."""
        try:
            shm = attach_shared_memory(shm_name(process_index, run_id))
        except FileNotFoundError:
            return False
        unlink_shared_memory(shm)
        return True

    # ---- load ------------------------------------------------------------

    def load(self, leaves: Sequence[core.Leaf], step: Optional[int] = None,
             partial: bool = False, bridge=None) -> Optional[int]:
        """Restore into ``leaves`` in place: the segment if it holds a
        complete pack of this directory (and of ``step`` when given), else
        a ring peer's copy (with a replica manager), else committed
        storage. Returns the restored step, or None if there is none.
        ``bridge``: ``core.restore_leaves``'s, for every tier. A
        tree-contract violation (``core.RestoreMismatchError``) in the
        memory or replica tier falls through to storage, the source of
        truth, but re-raises when no tier restores: a silent restart from
        scratch is the worst outcome of a restore bug."""
        mismatch = None
        t0 = time.perf_counter()
        reg0 = self.register_seconds
        fetched: Dict = {}
        with get_tracer().span("failover.restore") as span:
            tier = "none"
            try:
                got = self._load_from_memory(leaves, step, partial,
                                              bridge)
                if got is not None:
                    tier = "memory"
            except core.RestoreMismatchError as e:
                mismatch, got = e, None
            if got is None:
                try:
                    got = self._load_from_replica(leaves, step, partial,
                                                  bridge, fetched)
                    if got is not None:
                        tier = "replica"
                        span.args["holder"] = fetched.get("holder")
                except core.RestoreMismatchError as e:
                    mismatch, got = mismatch or e, None
            if got is None:
                got = self.load_from_storage(leaves, step, partial, bridge)
                if got is not None:
                    tier = "storage"
            span.args["tier"] = tier
            if got is None and mismatch is not None:
                raise mismatch
        seconds = time.perf_counter() - t0
        if got is not None:
            self._local_step = got
        self.timings.append({"kind": "restore", "tier": tier, "step": got,
                             "at": t0,
                             "register_s": self.register_seconds - reg0,
                             "seconds": seconds,
                             **(fetched if tier == "replica" else {})})
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(telemetry.CheckpointRecord(
                kind="restore", step=self._local_step, seconds=seconds,
                ok=tier != "none", tier=tier))
        return got

    def _staged(self) -> Optional[Dict]:
        """Agent mode: the agent's record of this worker's staged pack."""
        meta = self._agent_meta.get(meta_key(self.local_rank))
        if not meta or meta["dir"] != self.ckpt_dir:
            return None
        return meta

    def _load_from_memory(self, leaves, step, partial, bridge=None
                          ) -> Optional[int]:
        idx = core.PackIndex()
        try:
            name = shm_name(self.process_index)
            if self._use_agent:
                meta = self._staged()
                if meta is None:
                    return None
                name = meta["shm"]
            if self._buf is None:
                # the run's segment, staged by an earlier engine or process:
                # this engine adopts it, for this restore and its next saves
                self._adopt(attach_shared_memory(name))
            doc = core.read_header(self._buf)
            if doc is None or doc.get("extra", {}).get("dir") != self.ckpt_dir:
                return None
            if self._use_agent and doc["step"] != meta["step"]:
                return None  # torn since the agent recorded it
            if step is not None and doc["step"] != step:
                return None
            if self._client is not None:
                # all ranks must resume the same staged step
                min_step = self._client.get_min_ckpt_step()
                if min_step != doc["step"]:
                    logger.warning(
                        "staged step %s inconsistent with cluster min %s",
                        doc["step"], min_step)
                    return None
            if any(s.tensor.is_cuda for leaf in leaves for s in leaf.shards):
                # page-locked, the copies run at the bus's rate; pageable,
                # each first touch of a page faults (a few GB/s at best)
                self._register()
            idx.add_pack(self._buf)
            core.restore_leaves(leaves, idx, partial, bridge)
            self.restored_extra = dict(idx.extra)
            logger.info("restored step %d from shared memory", idx.step)
            return idx.step
        except (FileNotFoundError, KeyError):
            return None
        except core.RestoreMismatchError:
            raise  # load() decides its fate
        except Exception:  # noqa: BLE001 — a cache tier: storage decides
            logger.warning("memory restore failed", exc_info=True)
            return None
        finally:
            idx.close()

    def _load_from_replica(self, leaves, step, partial, bridge=None,
                           fetched: Optional[Dict] = None) -> Optional[int]:
        """No staged pack of this rank here (its host was replaced): its
        pack from a ring peer. Pinned to the master's minimum staged step
        (a peer may hold a step the other ranks did not stage: restoring
        it would diverge this rank from the rest); a holder whose pack
        fails to restore is skipped for the next. ``fetched`` gets the
        holder, the fetch's bytes and seconds and the ``digest``."""
        if self._replica is None:
            return None
        fetched = {} if fetched is None else fetched
        try:
            if step is None and self._client is not None:
                min_step = self._client.get_min_ckpt_step()
                if min_step > 0:
                    step = min_step
            tried: set = set()
            while True:
                t0 = time.perf_counter()
                with get_tracer().span("ckpt.replica_fetch") as span:
                    hit = self._replica.fetch(step=step,
                                              exclude=tuple(tried),
                                              with_holder=True)
                    if hit is not None:
                        span.args.update(holder=hit[2], nbytes=len(hit[1]))
                if hit is None:
                    return None
                got_step, pack, holder = hit
                fetched.update(holder=holder, fetch_nbytes=len(pack),
                               fetch_s=time.perf_counter() - t0)
                idx = core.PackIndex()
                try:
                    idx.add_pack(pack)
                    core.restore_leaves(leaves, idx, partial, bridge)
                    self.restored_extra = dict(idx.extra)
                except core.RestoreMismatchError:
                    raise  # load() decides its fate
                except Exception:  # noqa: BLE001 — the next holder's
                    logger.warning("replica restore from holder rank %d "
                                   "failed; trying the next peer", holder,
                                   exc_info=True)
                    tried.add(holder)
                    continue
                finally:
                    idx.close()
                if self.replica_digest is not None:
                    fetched["digest"] = self.replica_digest(memoryview(pack))
                logger.info("restored step %d from a peer replica (holder "
                            "rank %d)", got_step, holder)
                return got_step
        except core.RestoreMismatchError:
            raise
        except Exception:  # noqa: BLE001 — a cache tier: storage decides
            logger.warning("replica restore failed", exc_info=True)
            return None

    def load_from_storage(self, leaves, step=None, partial=False,
                          bridge=None) -> Optional[int]:
        step = step if step is not None else read_tracker(
            self.ckpt_dir, self._storage)
        if step is None:
            return None
        step_dir = os.path.join(self.ckpt_dir, f"step_{step}")
        packs = sorted(f for f in self._storage.listdir(step_dir)
                       if f.endswith(".pack"))
        if not packs:
            return None
        own = f"host_{self.process_index}.pack"
        if own in packs:
            # this rank's own pack first: under replicated data parallelism
            # it is the whole state, and at the layout that wrote it every
            # shard reads from it; another layout's shards are assembled
            # from the others (mapped, nothing read until a slice is)
            packs = [own] + [p for p in packs if p != own]
        idx = core.PackIndex()
        try:
            for name in packs:
                idx.add_pack(self._storage.mmap(os.path.join(step_dir, name)))
            core.restore_leaves(leaves, idx, partial, bridge)
            self.restored_extra = dict(idx.extra)
        finally:
            idx.close()
        logger.info("restored step %d from %s", step, step_dir)
        return step
