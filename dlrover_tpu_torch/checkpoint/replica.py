"""Cross-node in-memory checkpoint redundancy: the replica ring.

Port of ``dlrover_tpu/checkpoint/replica.py`` (reference: dlrover's
flash_checkpoint replica.py, CkptReplicaManger:28,
ShardCkptReplicaManager:73). Each node backs its staged pack up to its
ring successors (rank i to (i + k) mod n, k = 1..``num_replicas``), so
that when a node is lost with its shared memory, its replacement
restores the pack from a peer's RAM instead of from storage. The
backup is plain host networking: a small TCP store a node holding the
latest pack of each source rank, found through the master's KV store
(``ckpt_replica_addr_<rank>``). The frames and the auth preamble are
the JAX package's byte for byte, so the two packages' rings talk to
each other.

Where the store lives (``Checkpointer(replicate=True)``):

- Under the node's agent, the agent's ``AsyncCheckpointSaver`` runs the
  ``ReplicaManager`` (``saver.py``): a worker restart, which every
  surviving node goes through when a peer node is lost, does not take
  the peers' packs with it. The worker holds a manager with
  ``serve=False``, which fetches and polls but holds nothing.
- Standalone, the worker runs it, as the JAX ``Checkpointer`` does.

Guards kept from the JAX module: the backup re-reads the staged pack's
header step under the staging lock and gives up if the segment holds
another step (a newer staging superseded it, or the header length still
reads 0: the pack is being written, its card copies not yet done); the
store's byte budget; the auth check before any frame is parsed; a dead
peer's address forgotten so the next call re-resolves it. One limit is
not kept: a payload is read up to the store's byte budget, where the
JAX ring reads it under the sockets' 2 GiB frame cap and so refuses any
larger pack (llama-1.4b's is 2.81 GB at 2 layers).
"""

import json
import os
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.multi_process import attach_shared_memory
from dlrover_tpu_torch.common.sockets import (
    check_auth,
    default_token,
    recv_exact,
    send_auth,
)
from dlrover_tpu_torch.observability.tracing import get_tracer

logger = get_logger(__name__)

_LEN_BYTES = 8
_CHUNK = 16 << 20
_KV_PREFIX = "ckpt_replica_addr_"
_MAX_STEP = 1 << 40


def _default_advertise_host() -> str:
    """A routable address of this host: ``DLROVER_TPU_REPLICA_HOST``, else
    the source address of the outbound route (no packet is sent), else
    the host name's."""
    env = os.environ.get("DLROVER_TPU_REPLICA_HOST")
    if env:
        return env
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # no packets sent
            return s.getsockname()[0]
    except OSError:
        pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _send_frame(sock: socket.socket, header: Dict, payload=None):
    raw = json.dumps(header).encode("utf-8")
    sock.sendall(len(raw).to_bytes(_LEN_BYTES, "little"))
    sock.sendall(raw)
    if payload is not None:
        mv = memoryview(payload)
        for lo in range(0, len(mv), _CHUNK):
            sock.sendall(mv[lo: lo + _CHUNK])


def _recv_header(sock: socket.socket) -> Dict:
    n = int.from_bytes(recv_exact(sock, _LEN_BYTES), "little")
    if n > (1 << 20):
        raise ValueError(f"oversize frame header ({n} bytes)")
    return json.loads(bytes(recv_exact(sock, n)))


def _recv_payload(sock: socket.socket, header: Dict,
                  max_bytes: Optional[int] = None) -> Optional[bytearray]:
    """The frame's payload, up to ``max_bytes`` (the store's budget; the
    sockets' frame cap without one). The JAX module reads every payload
    under that 2 GiB cap, so its ring refuses a larger pack (ROADMAP C);
    a pack the store's budget admits is read here."""
    size = int(header.get("size", 0))
    if max_bytes is not None and size > max_bytes:
        # refused before a buffer of the peer's choosing is allocated
        raise ValueError(f"oversize payload ({size} > {max_bytes})")
    if not size:
        return None
    return (recv_exact(sock, size) if max_bytes is None
            else recv_exact(sock, size, max_bytes))


def _recv_frame(sock: socket.socket, max_bytes: Optional[int] = None
                ) -> Tuple[Dict, Optional[bytearray]]:
    header = _recv_header(sock)
    return header, _recv_payload(sock, header, max_bytes)


class _ReplicaStore:
    """The latest pack of each source rank, within a byte budget."""

    def __init__(self, max_bytes: int):
        self._lock = threading.Lock()
        self._packs: Dict[int, Tuple[int, bytes]] = {}  # src -> (step, pack)
        self._max_bytes = max_bytes

    def put(self, src: int, step: int, pack) -> bool:
        with self._lock:
            cur = self._packs.get(src)
            if cur and cur[0] >= step:
                return True  # a stale resend
            other = sum(len(p) for s, (_, p) in self._packs.items()
                        if s != src)
            if other + len(pack) > self._max_bytes:
                logger.warning(
                    "replica store over budget (%d + %d > %d), dropping the "
                    "backup from rank %d", other, len(pack), self._max_bytes,
                    src)
                return False
            self._packs[src] = (step, pack)
            return True

    def get(self, src: int) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            return self._packs.get(src)

    def steps(self) -> Dict[int, int]:
        with self._lock:
            return {s: step for s, (step, _) in self._packs.items()}

    def drop(self, src: int):
        with self._lock:
            self._packs.pop(src, None)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        store: _ReplicaStore = self.server.store  # type: ignore[attr-defined]
        # the preamble before any frame: an unauthenticated put must not
        # force a multi-GB allocation; a refusal closes without answering
        if not check_auth(self.request, self.server.token):  # type: ignore
            return
        try:
            header = _recv_header(self.request)
            payload = _recv_payload(
                self.request, header,
                self.server.max_frame_bytes)  # type: ignore[attr-defined]
        except (ConnectionError, json.JSONDecodeError, OSError, ValueError):
            return
        op = header.get("op")
        if op == "put":
            step = int(header["step"])
            if not 0 <= step < _MAX_STEP:
                _send_frame(self.request, {"ok": False, "error": "bad step"})
                return
            # stored as received: a bytes() copy would double the RAM of a
            # multi-GB pack for a moment
            ok = store.put(int(header["src"]), step, payload or bytearray())
            _send_frame(self.request, {"ok": ok})
        elif op == "get":
            hit = store.get(int(header["src"]))
            if hit is None:
                _send_frame(self.request, {"ok": False, "size": 0})
            else:
                step, pack = hit
                _send_frame(self.request,
                            {"ok": True, "step": step, "size": len(pack)},
                            pack)
        elif op == "steps":
            # JSON makes the int keys strings; the receiver turns them back
            _send_frame(self.request, {"ok": True, "steps": store.steps()})
        else:
            _send_frame(self.request, {"ok": False, "error": "bad op"})


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


@dataclass
class ReplicaConfig:
    """``num_replicas``: how many ring successors get a copy (0: none)."""

    num_replicas: int = 1
    bind_host: str = "0.0.0.0"
    advertise_host: str = field(default_factory=_default_advertise_host)
    port: int = 0  # 0: an ephemeral port
    max_store_bytes: int = 8 << 30
    timeout: float = 60.0
    token: str = field(default_factory=default_token)


class ReplicaManager:
    """Ring backup of staged checkpoint packs across nodes.

    ``peers`` maps a rank to its store's "host:port", given (tests, static
    clusters) or resolved through the master's KV store. ``serve=False``:
    no store of this node's own (a worker whose agent holds it): no
    server, no registration, and a fetch from this rank's own store goes
    over the wire to the address the KV store names."""

    def __init__(self, process_index: int, process_count: int,
                 peers: Optional[Dict[int, str]] = None, master_client=None,
                 config: Optional[ReplicaConfig] = None, serve: bool = True):
        self.process_index = process_index
        self.process_count = process_count
        self.config = config or ReplicaConfig()
        self._peers = dict(peers or {})
        self._client = master_client
        self._store = _ReplicaStore(self.config.max_store_bytes)
        self._server: Optional[_Server] = None
        self._backup_thread: Optional[threading.Thread] = None
        if serve:
            self._server = _Server((self.config.bind_host, self.config.port),
                                   _Handler)
            self._server.store = self._store  # type: ignore[attr-defined]
            self._server.token = self.config.token  # type: ignore
            self._server.max_frame_bytes = (  # type: ignore[attr-defined]
                self.config.max_store_bytes)
            # a short poll: ``close`` waits for the loop's next turn
            threading.Thread(target=self._server.serve_forever,
                             kwargs={"poll_interval": 0.05},
                             name="ckpt-replica", daemon=True).start()
            self.register()

    # ---- discovery -------------------------------------------------------

    @property
    def addr(self) -> str:
        port = self._server.server_address[1] if self._server else 0
        return f"{self.config.advertise_host}:{port}"

    def register(self):
        if self._client is None or self._server is None:
            return
        try:
            self._client.kv_store_set(f"{_KV_PREFIX}{self.process_index}",
                                      self.addr)
        except Exception:  # noqa: BLE001
            logger.warning("replica addr registration failed", exc_info=True)

    def _resolve(self, rank: int) -> Optional[str]:
        if rank in self._peers:
            return self._peers[rank]
        if self._client is None:
            return None
        try:
            addr = self._client.kv_store_get(f"{_KV_PREFIX}{rank}")
        except Exception:  # noqa: BLE001
            return None
        if addr:
            self._peers[rank] = addr
            return addr
        return None

    def holders(self, src: int):
        """The ring successors that hold rank ``src``'s pack."""
        n = self.process_count
        r = min(self.config.num_replicas, n - 1)
        return [(src + i) % n for i in range(1, r + 1)]

    def _backup_targets(self):
        return self.holders(self.process_index)

    # ---- backup (sender side) --------------------------------------------

    def backup(self, meta: Dict, shm_lock=None) -> int:
        """Send this node's staged pack to its ring successors; the number
        of peers updated.

        ``meta`` is the engine's staging record ({shm, used, step}). One
        host copy of the pack is made under ``shm_lock`` (the segment's
        staging lock), so the sends run without it; under the lock the
        pack header's step is read again, and the backup gives up when it
        is not ``meta``'s (a newer staging superseded it, whose own backup
        follows; or the header length reads 0: the pack is being written,
        its card copies not yet done)."""
        from dlrover_tpu_torch.checkpoint import core

        targets = self._backup_targets()
        if not targets:
            return 0
        # one cheap KV set a backup heals a registration the master missed
        self.register()
        span = get_tracer().span("ckpt.replica_backup", step=meta["step"],
                                 nbytes=meta["used"])
        with span:
            if shm_lock is not None and not shm_lock.acquire(blocking=True):
                return 0
            try:
                shm = attach_shared_memory(meta["shm"])
                try:
                    view = memoryview(shm.buf)
                    doc = core.read_header(view)
                    staged = doc.get("step") if doc else None
                    if staged != meta["step"]:
                        logger.info("skipping the replica backup of step %s: "
                                    "the segment holds step %s",
                                    meta["step"], staged)
                        return 0
                    pack = bytes(view[: meta["used"]])
                finally:
                    del view
                    shm.close()
            except FileNotFoundError:
                return 0
            finally:
                if shm_lock is not None:
                    shm_lock.release()
            sent = 0
            for rank in targets:
                addr = self._resolve(rank)
                if addr is None:
                    logger.warning("no replica addr for rank %d", rank)
                    continue
                if self._put(addr, meta["step"], pack):
                    sent += 1
            span.args["sent"] = sent
        return sent

    def backup_async(self, meta: Dict, shm_lock=None):
        """Start a backup without blocking the caller; skipped while the
        previous one is still in flight (the next save retries, and the
        header check of ``backup`` keeps a skipped step from being sent
        under another step's label)."""
        if self._backup_thread and self._backup_thread.is_alive():
            logger.warning("replica backup of step %s skipped: the previous "
                           "backup is still in flight", meta.get("step"))
            return
        self._backup_thread = threading.Thread(
            target=self._safe_backup, args=(meta, shm_lock), daemon=True,
            name="ckpt-replica-backup")
        self._backup_thread.start()

    def _safe_backup(self, meta, shm_lock):
        try:
            self.backup(meta, shm_lock)
        except Exception:  # noqa: BLE001
            logger.warning("checkpoint replica backup failed", exc_info=True)

    def wait_backup(self, timeout: float = 120.0):
        if self._backup_thread:
            self._backup_thread.join(timeout)

    def _put(self, addr: str, step: int, pack: bytes) -> bool:
        try:
            with self._connect(addr) as sock:
                _send_frame(sock, {"op": "put", "src": self.process_index,
                                   "step": step, "size": len(pack)}, pack)
                resp, _ = _recv_frame(sock)
                return bool(resp.get("ok"))
        except OSError:
            logger.warning("replica backup to %s failed", addr, exc_info=True)
            self._forget(addr)
            return False

    def _forget(self, addr: str):
        """Drop a dead peer's address so the next call re-resolves it (a
        relaunched peer registers a new port). A static map is kept."""
        if self._client is None:
            return
        for rank, a in list(self._peers.items()):
            if a == addr:
                del self._peers[rank]

    # ---- restore (fetch side) --------------------------------------------

    def fetch(self, src: Optional[int] = None, step: Optional[int] = None,
              exclude: Tuple[int, ...] = (), with_holder: bool = False):
        """Rank ``src``'s pack (this rank's by default) from the first of
        its holders that has it (at ``step``, when given): (step, pack) or,
        ``with_holder``, (step, pack, holder rank); None when no holder
        outside ``exclude`` (those that failed a restore already) has it."""
        src = self.process_index if src is None else src
        skip = frozenset(exclude)
        for rank in self.holders(src):
            if rank in skip:
                continue
            if rank == self.process_index and self._server is not None:
                hit = self._store.get(src)
            else:
                addr = self._resolve(rank)
                if addr is None:
                    continue
                hit = self._get(addr, src)
            if hit is None:
                continue
            got_step, pack = hit
            if step is not None and got_step != step:
                continue
            logger.info("recovered rank %d step %d pack (%.1f MB) from peer "
                        "rank %d", src, got_step, len(pack) / 1e6, rank)
            if with_holder:
                return got_step, pack, rank
            return got_step, pack
        return None

    def peer_steps(self, rank: int) -> Dict[int, int]:
        """{src: step} of the packs ``rank``'s store holds."""
        addr = self._resolve(rank)
        if addr is None:
            return {}
        try:
            with self._connect(addr) as sock:
                _send_frame(sock, {"op": "steps"})
                resp, _ = _recv_frame(sock)
                return {int(k): int(v)
                        for k, v in resp.get("steps", {}).items()}
        except OSError:
            return {}

    def _get(self, addr: str, src: int) -> Optional[Tuple[int, bytes]]:
        try:
            with self._connect(addr) as sock:
                _send_frame(sock, {"op": "get", "src": src})
                resp, payload = _recv_frame(sock,
                                            self.config.max_store_bytes)
                if not resp.get("ok"):
                    return None
                return int(resp["step"]), payload or bytearray()
        except OSError:
            self._forget(addr)
            return None

    def _connect(self, addr: str) -> socket.socket:
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=self.config.timeout)
        send_auth(sock, self.config.token)
        return sock

    # ---- lifecycle -------------------------------------------------------

    def local_steps(self) -> Dict[int, int]:
        """{src: step} of the packs this node holds for others."""
        return self._store.steps()

    def close(self):
        self.wait_backup(timeout=5.0)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()


def wait_peer_steps(manager: ReplicaManager, want: Dict[int, int],
                    timeout: float = 30.0,
                    holder: Optional[int] = None) -> bool:
    """Block until this node's store (or, with ``holder``, that rank's,
    asked over the wire) holds at least ``want`` {src: step}."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        have = (manager.local_steps() if holder is None
                else manager.peer_steps(holder))
        if all(have.get(s, -1) >= st for s, st in want.items()):
            return True
        time.sleep(0.02)
    return False
