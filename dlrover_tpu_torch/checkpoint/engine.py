"""Worker-side checkpoint engine: device → host shared memory, async persist.

Port of ``CheckpointEngine`` of ``dlrover_tpu/checkpoint/engine.py`` in
its standalone mode (no agent): the worker blocks only for the copy of
its state into a named POSIX segment; a thread of the engine persists
the segment to storage and commits the tracker. Restore reads the
segment when it holds a complete pack of this checkpoint directory,
else the committed storage. The agent mode (queue, dict and lock
served by the agent, ROADMAP A8) and the peer replica tier (ROADMAP
A10's ring) are not ported yet.

Two things differ from the JAX engine, each for a reason:

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
"""

import collections
import os
import threading
import time
from typing import Dict, Optional, Sequence

import torch

from dlrover_tpu_torch.checkpoint import core
from dlrover_tpu_torch.checkpoint.saver import persist_pack
from dlrover_tpu_torch.checkpoint.storage import PosixStorage, read_tracker
from dlrover_tpu_torch.common.constants import GraftEnv
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.multi_process import (
    attach_shared_memory,
    create_shared_memory,
    unlink_shared_memory,
)
from dlrover_tpu_torch.observability import telemetry
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)

SHM_DIR = "/dev/shm"


def shm_name(process_index: int = 0) -> str:
    """The staging segment's name: one per run (``DLROVER_TPU_RUN_ID``)
    and process."""
    run_id = os.environ.get(GraftEnv.RUN_ID, "default")
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

    def __init__(self, ckpt_dir: str, storage=None):
        self.ckpt_dir = ckpt_dir
        self._storage = storage or PosixStorage()
        self._shm = None
        self._buf: Optional[torch.Tensor] = None  # uint8 over the segment
        self._registered = False
        self.register_seconds = 0.0
        self._local_step = -1
        self._latest: Optional[Dict] = None  # the staged pack's meta
        self._lock = threading.Lock()
        self._persist_thread: Optional[threading.Thread] = None
        self._persist_error: Optional[BaseException] = None
        self.timings: collections.deque = collections.deque(maxlen=256)

    # ---- save ------------------------------------------------------------

    def save_to_memory(self, step: int, leaves: Sequence[core.Leaf]) -> bool:
        """Stage ``leaves`` into shared memory. Returns False if skipped
        (a persist is reading the segment)."""
        return self._stage(step, leaves, "save_memory", 0.0, hold=False)

    def save_to_storage(self, step: int, leaves: Sequence[core.Leaf]) -> bool:
        """Wait for the previous persist, stage, and persist on a thread."""
        t0 = time.perf_counter()
        self._join_persist()
        wait_s = time.perf_counter() - t0
        if not self._stage(step, leaves, "save_storage", wait_s, hold=True):
            return False
        meta = dict(self._latest)
        self._persist_thread = threading.Thread(
            target=self._persist_standalone, args=(meta,), daemon=True,
            name="ckpt-persist")
        self._persist_thread.start()
        return True

    def _stage(self, step, leaves, kind, wait_s, hold) -> bool:
        """Stage under the lock; with ``hold`` the lock stays held for the
        caller's persist, which releases it."""
        t0 = time.perf_counter()
        entries, payload = core.plan_pack(leaves)
        header = core.header_bytes(step, entries, {"dir": self.ckpt_dir})
        total = core.pack_size(header, payload)
        if not self._lock.acquire(blocking=False):
            logger.warning("step %d: a persist is reading the segment, "
                           "skipping the memory save", step)
            self.timings.append({"kind": "skipped", "step": step})
            return False
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
                "shm": self._shm.name, "process_index": 0,
                "process_count": 1, "time": time.time(),
            }
            self._local_step = step
            staged = True
        finally:
            if not (staged and hold):
                self._lock.release()
            span.end()
        rec = {"kind": kind, "step": step, "nbytes": total, "at": t0,
               "register_s": t_copy - t_reg, "copy_s": t_end - t_copy,
               "wait_s": wait_s, "seconds": wait_s + t_end - t0}
        self.timings.append(rec)
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(telemetry.CheckpointRecord(
                kind="save_memory", step=step, seconds=rec["seconds"],
                nbytes=total, tier="memory"))
        logger.info("staged step %d to shm in %.3fs (%.1f MB)", step,
                    rec["seconds"], total / 1e6)
        return True

    def _ensure_segment(self, total: int, on_card: bool) -> None:
        if self._shm is None or self._shm.size < total:
            self._close_segment()
            name = shm_name()
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

    def wait_for_persist(self, timeout: float = 300.0) -> bool:
        """Block until the latest staged step is committed to storage.
        Returns False, and publishes a failed ``persist_wait`` record, when
        the commit does not land inside ``timeout``; raises when the
        persist failed."""
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
        """Wait for the persist, then release the segment (it stays in
        /dev/shm for a later restore; ``unlink_segment`` removes it)."""
        self._join_persist()
        self._close_segment()

    @staticmethod
    def unlink_segment() -> bool:
        """Remove this run's staging segment; False if there was none."""
        try:
            shm = attach_shared_memory(shm_name())
        except FileNotFoundError:
            return False
        unlink_shared_memory(shm)
        return True

    # ---- load ------------------------------------------------------------

    def load(self, leaves: Sequence[core.Leaf], step: Optional[int] = None,
             partial: bool = False) -> Optional[int]:
        """Restore into ``leaves`` in place: the segment if it holds a
        complete pack of this directory (and of ``step`` when given), else
        committed storage. Returns the restored step, or None if there is
        none. A tree-contract violation (``core.RestoreMismatchError``) in
        the memory tier falls through to storage, the source of truth, but
        re-raises when no tier restores: a silent restart from scratch is
        the worst outcome of a restore bug."""
        mismatch = None
        t0 = time.perf_counter()
        reg0 = self.register_seconds
        with get_tracer().span("failover.restore") as span:
            tier = "none"
            try:
                got = self._load_from_memory(leaves, step, partial)
                if got is not None:
                    tier = "memory"
            except core.RestoreMismatchError as e:
                mismatch, got = e, None
            if got is None:
                got = self.load_from_storage(leaves, step, partial)
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
                             "seconds": seconds})
        hub = telemetry.get_hub()
        if hub.enabled:
            hub.publish(telemetry.CheckpointRecord(
                kind="restore", step=self._local_step, seconds=seconds,
                ok=tier != "none", tier=tier))
        return got

    def _load_from_memory(self, leaves, step, partial) -> Optional[int]:
        idx = core.PackIndex()
        try:
            if self._buf is None:
                # the run's segment, staged by an earlier engine or process:
                # this engine adopts it, for this restore and its next saves
                self._adopt(attach_shared_memory(shm_name()))
            doc = core.read_header(self._buf)
            if doc is None or doc.get("extra", {}).get("dir") != self.ckpt_dir:
                return None
            if step is not None and doc["step"] != step:
                return None
            if any(s.tensor.is_cuda for leaf in leaves for s in leaf.shards):
                # page-locked, the copies run at the bus's rate; pageable,
                # each first touch of a page faults (a few GB/s at best)
                self._register()
            idx.add_pack(self._buf)
            core.restore_leaves(leaves, idx, partial)
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

    def load_from_storage(self, leaves, step=None, partial=False
                          ) -> Optional[int]:
        step = step if step is not None else read_tracker(
            self.ckpt_dir, self._storage)
        if step is None:
            return None
        step_dir = os.path.join(self.ckpt_dir, f"step_{step}")
        packs = sorted(f for f in self._storage.listdir(step_dir)
                       if f.endswith(".pack"))
        if not packs:
            return None
        idx = core.PackIndex()
        try:
            for name in packs:
                idx.add_pack(self._storage.mmap(os.path.join(step_dir, name)))
            core.restore_leaves(leaves, idx, partial)
        finally:
            idx.close()
        logger.info("restored step %d from %s", step, step_dir)
        return step
