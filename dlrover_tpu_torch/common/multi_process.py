"""Named POSIX shared memory that outlives the process that made it.

Port of ``create_shared_memory`` and ``attach_shared_memory`` from
``dlrover_tpu/common/multi_process.py``: checkpoint staging rides a
named segment, and Python's resource tracker would unlink a segment
when any process that attached it exits, exactly wrong for staging that
must survive a worker crash. Both helpers therefore unregister the
segment from the tracker. The socket brokers of the JAX module (queue,
dict, lock between agent and worker) belong to the agent and are not
ported yet (ROADMAP A8).
"""

from multiprocessing import resource_tracker, shared_memory


def _untrack(shm: shared_memory.SharedMemory) -> shared_memory.SharedMemory:
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:  # noqa: BLE001 — the tracker may not know the name
        pass
    return shm


def attach_shared_memory(name: str) -> shared_memory.SharedMemory:
    """Attach to the segment ``name``; raises FileNotFoundError when it
    does not exist."""
    return _untrack(shared_memory.SharedMemory(name=name))


def unlink_shared_memory(shm: shared_memory.SharedMemory) -> None:
    """Close and remove ``shm`` (attached by the helpers above)."""
    shm.close()
    # SharedMemory.unlink also unregisters the name from the tracker,
    # which no longer knows it: register it back first
    resource_tracker.register(shm._name, "shared_memory")  # noqa: SLF001
    shm.unlink()


def create_shared_memory(name: str, size: int) -> shared_memory.SharedMemory:
    """The segment ``name`` with at least ``size`` bytes: the existing one
    when it is large enough, else a new one in its place."""
    try:
        old = attach_shared_memory(name)
        if old.size >= size:
            return old
        unlink_shared_memory(old)
    except FileNotFoundError:
        pass
    return _untrack(shared_memory.SharedMemory(name=name, create=True,
                                               size=size))
