"""Local agent↔worker IPC: named shared memory, queue, dict, lock.

Port of ``dlrover_tpu/common/multi_process.py`` (reference:
dlrover/python/common/multi_process.py:225,346,453,537). The *agent*
process serves a queue, a dict and a lock over unix sockets, workers
connect by name, and checkpoint payloads ride named POSIX shared memory
that outlives a worker crash.

- The segment helpers unregister every segment from Python's resource
  tracker, which would unlink a segment when any process that attached
  it exits, exactly wrong for staging that must survive a worker crash.
- The brokers' sockets live under ``DLROVER_TPU_SOCK_DIR`` (default: a
  directory in the temporary directory) and are named by the run
  (``DLROVER_TPU_RUN_ID``) and the port (``torch_``), so runs on one
  host, and the JAX package's brokers, never share one.
- ``SharedLock`` releases a lock whose holder process is gone: a worker
  killed while it held the lock (mid-stage) must not leave the agent's
  persist waiting. The JAX lock waits out its timeout (60 s) instead.
"""

import hashlib
import json
import os
import socket
import socketserver
import tempfile
import threading
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)


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


# ---------------------------------------------------------------------------
# Unix-socket RPC primitives (agent = server, worker = client)
# ---------------------------------------------------------------------------


def socket_dir() -> str:
    return os.environ.get(
        "DLROVER_TPU_SOCK_DIR",
        os.path.join(tempfile.gettempdir(), "dlrover_tpu_sockets"))


_UNIX_PATH_MAX = 107


def _socket_path(name: str) -> str:
    """The socket of ``name`` in this run; a name that would pass the
    unix-socket path limit is hashed (the run id stays part of it)."""
    d = socket_dir()
    os.makedirs(d, exist_ok=True)
    run_id = os.environ.get("DLROVER_TPU_RUN_ID", "default")
    path = os.path.join(d, f"torch_{run_id}_{name}.sock")
    if len(path.encode()) > _UNIX_PATH_MAX:
        digest = hashlib.sha1(f"{run_id}/{name}".encode()).hexdigest()[:20]
        path = os.path.join(d, f"torch_{digest}.sock")
        if len(path.encode()) > _UNIX_PATH_MAX:
            raise OSError(f"the IPC socket directory {d} is too long for a "
                          "unix socket; set DLROVER_TPU_SOCK_DIR to a "
                          "shorter one")
    return path


def broker_alive(name: str) -> bool:
    """True iff a live broker is serving ``name``'s socket.

    The socket FILE alone proves nothing: a SIGKILLed agent leaves its
    socket behind. Probe with a real connect and unlink the corpse on
    refusal so the namespace heals for the next caller.
    """
    path = _socket_path(name)
    if not os.path.exists(path):
        return False
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(1.0)
        try:
            s.connect(path)
            return True
        except OSError:
            logger.warning(
                "stale IPC socket %s (broker gone); removing it", path
            )
            try:
                os.unlink(path)
            except OSError:
                pass
            return False


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            line = self.rfile.readline()
            if not line:
                return
            req = json.loads(line)
            resp = self.server.owner._handle(req)  # type: ignore[attr-defined]
            self.wfile.write((json.dumps(resp) + "\n").encode())
        except Exception as e:  # noqa: BLE001
            try:
                self.wfile.write(
                    (json.dumps({"ok": False, "err": str(e)}) + "\n").encode()
                )
            except Exception:  # noqa: BLE001
                pass


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    # the lock's waiters hold their connections while they wait; the
    # default backlog of 5 refuses the next connect (EAGAIN)
    request_queue_size = 128


class _LocalServer:
    """One unix-socket server per named primitive."""

    def __init__(self, name: str):
        self.name = name
        self.path = _socket_path(name)
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._server = _UnixServer(self.path, _Handler)
        self._server.owner = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"ipc-{name}",
            daemon=True,
        )
        self._thread.start()

    def _handle(self, req: Dict) -> Dict:
        raise NotImplementedError

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        if os.path.exists(self.path):
            os.unlink(self.path)


def _connect(s: socket.socket, path: str, timeout: float) -> None:
    """Connect, waiting while the broker's backlog is full."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            s.connect(path)
            return
        except BlockingIOError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.01)


def _client_call(name: str, req: Dict, timeout: float = 30.0) -> Dict:
    path = _socket_path(name)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        _connect(s, path, timeout)
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


# ---- SharedQueue ----------------------------------------------------------


class SharedQueue(_LocalServer):
    """Agent-side FIFO; workers put/get by name."""

    def __init__(self, name: str):
        super().__init__(f"queue_{name}")
        self._items: List[Any] = []
        self._cond = threading.Condition()

    def _handle(self, req: Dict) -> Dict:
        op = req["op"]
        if op == "put":
            with self._cond:
                self._items.append(req["item"])
                self._cond.notify()
            return {"ok": True}
        if op == "get":
            timeout = req.get("timeout", 0)
            with self._cond:
                if not self._items and timeout:
                    self._cond.wait(timeout)
                if self._items:
                    return {"ok": True, "item": self._items.pop(0)}
            return {"ok": False}
        if op == "qsize":
            with self._cond:
                return {"ok": True, "item": len(self._items)}
        return {"ok": False, "err": f"bad op {op}"}

    # server-side convenience (agent process)
    def get(self, timeout: float = 0) -> Optional[Any]:
        with self._cond:
            if not self._items and timeout:
                self._cond.wait(timeout)
            return self._items.pop(0) if self._items else None

    def put(self, item: Any):
        with self._cond:
            self._items.append(item)
            self._cond.notify()


class SharedQueueClient:
    def __init__(self, name: str):
        self._name = f"queue_{name}"

    def put(self, item: Any) -> bool:
        return _client_call(self._name, {"op": "put", "item": item})["ok"]

    def get(self, timeout: float = 0) -> Optional[Any]:
        resp = _client_call(
            self._name,
            {"op": "get", "timeout": timeout},
            timeout=timeout + 30.0,
        )
        return resp.get("item") if resp.get("ok") else None


# ---- SharedDict -----------------------------------------------------------


class SharedDict(_LocalServer):
    """Agent-side dict; workers set/get JSON values by key."""

    def __init__(self, name: str):
        super().__init__(f"dict_{name}")
        self._data: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _handle(self, req: Dict) -> Dict:
        op = req["op"]
        if op == "set":
            with self._lock:
                self._data[req["key"]] = req["value"]
            return {"ok": True}
        if op == "get":
            with self._lock:
                if req.get("key") is None:
                    return {"ok": True, "value": dict(self._data)}
                return {"ok": True, "value": self._data.get(req["key"])}
        if op == "delete":
            with self._lock:
                self._data.pop(req["key"], None)
            return {"ok": True}
        return {"ok": False, "err": f"bad op {op}"}

    def set(self, key: str, value: Any):
        with self._lock:
            self._data[key] = value

    def get(self, key: Optional[str] = None) -> Any:
        with self._lock:
            if key is None:
                return dict(self._data)
            return self._data.get(key)


class SharedDictClient:
    def __init__(self, name: str):
        self._name = f"dict_{name}"

    def set(self, key: str, value: Any) -> bool:
        return _client_call(
            self._name, {"op": "set", "key": key, "value": value}
        )["ok"]

    def get(self, key: Optional[str] = None) -> Any:
        return _client_call(self._name, {"op": "get", "key": key}).get("value")

    def delete(self, key: str) -> bool:
        return _client_call(self._name, {"op": "delete", "key": key})["ok"]


# ---- SharedLock -----------------------------------------------------------


def _pid_alive(pid: int) -> bool:
    """False once ``pid`` has exited, reaped or not (a zombie holds no
    lock)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state not in ("Z", "X")
    except (OSError, IndexError):
        return True


def _owner_alive(owner: str) -> bool:
    if owner.startswith("pid-"):
        try:
            return _pid_alive(int(owner[4:]))
        except ValueError:
            return True
    return True


class SharedLock(_LocalServer):
    """Agent-hosted mutex shared with workers (non-reentrant). A holder
    named ``pid-<pid>`` (a worker's client) whose process is gone holds
    it no more: the next acquire takes it over."""

    _POLL_S = 0.05

    def __init__(self, name: str):
        super().__init__(f"lock_{name}")
        self._holder: Optional[str] = None
        self._cond = threading.Condition()
        self.dead_holders: List[str] = []  # holders released as dead

    def _free(self) -> bool:
        """Lock held. True when no live process holds the lock."""
        if self._holder is not None and not _owner_alive(self._holder):
            logger.warning("lock %s: its holder %s is gone; releasing it",
                           self.name, self._holder)
            self.dead_holders.append(self._holder)
            self._holder = None
        return self._holder is None

    def _handle(self, req: Dict) -> Dict:
        op = req["op"]
        owner = req.get("owner", "anon")
        if op == "acquire":
            blocking = req.get("blocking", True)
            timeout = req.get("timeout", 60.0)
            deadline = time.monotonic() + timeout
            with self._cond:
                while not self._free():
                    left = deadline - time.monotonic()
                    if not blocking or left <= 0:
                        return {"ok": False}
                    self._cond.wait(min(left, self._POLL_S))
                self._holder = owner
                return {"ok": True}
        if op == "release":
            with self._cond:
                if self._holder == owner:
                    self._holder = None
                    self._cond.notify()
                    return {"ok": True}
            return {"ok": False}
        if op == "locked":
            with self._cond:
                return {"ok": True, "item": not self._free()}
        return {"ok": False, "err": f"bad op {op}"}

    def acquire(self, owner: str = "agent", blocking: bool = True,
                timeout: float = 60.0) -> bool:
        return self._handle({"op": "acquire", "owner": owner,
                             "blocking": blocking, "timeout": timeout})["ok"]

    def release(self, owner: str = "agent") -> bool:
        return self._handle({"op": "release", "owner": owner})["ok"]


class SharedLockClient:
    def __init__(self, name: str, owner: Optional[str] = None):
        self._name = f"lock_{name}"
        self._owner = owner or f"pid-{os.getpid()}"

    def acquire(self, blocking: bool = True, timeout: float = 60.0) -> bool:
        return _client_call(
            self._name,
            {
                "op": "acquire",
                "owner": self._owner,
                "blocking": blocking,
                "timeout": timeout,
            },
            timeout=timeout + 30.0,
        )["ok"]

    def release(self) -> bool:
        return _client_call(self._name, {"op": "release", "owner": self._owner})[
            "ok"
        ]
