"""The control plane's transport: two RPCs over length-prefixed frames.

Port of ``dlrover_tpu/common/comm.py``. The JAX package carries the
two-RPC shape of the reference (``report``: fire-and-forget, answered
with a ``Response``; ``get``: request → typed response) over gRPC
generic handlers. The port keeps the shape, the JSON codec of
``messages.py`` and the jittered retry backoff, and builds the wire on
the standard library (``socketserver``), so the port needs no ``grpc``:

    frame    = u32 big-endian length | body
    request  = b"r" (report) or b"g" (get) | message bytes
    response = status byte | payload
               0: the reply message; 1: an error's text (the JAX
               server's INTERNAL abort); 2: the text naming the ROADMAP
               item of a handler the port has not ported

A client opens one connection a call. It retries a refused, reset or
timed-out call (gRPC's UNAVAILABLE and DEADLINE_EXCEEDED) after
``_backoff_delay(attempt)``; it raises ``NotImplementedError`` with the
server's text for an unported handler and ``RemoteError`` for a failed
``get``.
"""

import random
import socket
import socketserver
import struct
import threading
from typing import Optional, Tuple

from dlrover_tpu_torch.common import messages as msgs
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

MAX_FRAME_BYTES = 64 * 1024 * 1024
OK, ERROR, UNPORTED = 0, 1, 2
_LEN = struct.Struct(">I")

# retry backoff: full-jittered exponential, bounded. A synchronized
# retry storm after a master restart is exactly the moment the master
# can least afford one — jitter decorrelates the herd.
_BACKOFF_BASE_S = 0.5
_BACKOFF_CAP_S = 15.0


def _backoff_delay(attempt: int) -> float:
    """Delay before retry ``attempt`` (0-based): exp growth from
    ``_BACKOFF_BASE_S`` capped at ``_BACKOFF_CAP_S``, with uniform
    jitter in [0.5, 1.0]× so concurrent clients decorrelate."""
    return min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * 2**attempt) * random.uniform(
        0.5, 1.0
    )


def _wait(seconds: float) -> None:
    threading.Event().wait(seconds)


class RemoteError(RuntimeError):
    """The master failed to answer a ``get`` (its handler raised)."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return bytes(buf)


def send_frame(sock: socket.socket, body: bytes) -> None:
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(body)} bytes exceeds "
                         f"{MAX_FRAME_BYTES}")
    sock.sendall(_LEN.pack(len(body)) + body)


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    """One frame's body, or None when the peer closed between frames."""
    head = sock.recv(_LEN.size, socket.MSG_WAITALL)
    if not head:
        return None
    if len(head) < _LEN.size:
        head += _recv_exact(sock, _LEN.size - len(head))
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"invalid frame length {n}")
    return _recv_exact(sock, n)


def split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host.strip("[]") or "localhost", int(port)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        owner: "MasterTransportServer" = self.server.owner  # type: ignore
        while True:
            try:
                body = recv_frame(self.request)
            except (ConnectionError, OSError):
                return
            if body is None:
                return
            try:
                send_frame(self.request, owner.dispatch(body))
            except (ConnectionError, OSError):
                return


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class MasterTransportServer:
    """Wraps a servicer exposing ``report(msg)``, ``get(msg)`` and
    ``unported(type_name)`` (the ROADMAP text of a handler the port has
    not ported, or None)."""

    def __init__(self, servicer, port: int = 0):
        self._servicer = servicer
        self._server = _Server(("", port), _Handler, bind_and_activate=True)
        self._server.owner = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def dispatch(self, body: bytes) -> bytes:
        """One request's response body."""
        method, payload = body[:1], body[1:]
        try:
            name = msgs.type_name(payload)
        except Exception as e:  # noqa: BLE001 — fault barrier at the edge
            return bytes([ERROR]) + f"undecodable request: {e}".encode()
        if not msgs.registered(name):
            text = self._servicer.unported(name) or (
                f"unknown message type {name}")
            return bytes([UNPORTED]) + text.encode()
        if method == b"r":
            try:
                success = bool(self._servicer.report(msgs.deserialize(payload)))
                reply = msgs.Response(success=success)
            except Exception as e:  # noqa: BLE001
                logger.exception("report failed")
                reply = msgs.Response(success=False, reason=str(e))
            return bytes([OK]) + msgs.serialize(reply)
        try:
            resp = self._servicer.get(msgs.deserialize(payload))
        except Exception as e:  # noqa: BLE001
            logger.exception("get failed")
            return bytes([ERROR]) + str(e).encode()
        return bytes([OK]) + msgs.serialize(
            msgs.Empty() if resp is None else resp)

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="master-transport",
            daemon=True)
        self._thread.start()
        logger.info("master transport listening on port %s", self.port)

    def stop(self, grace: Optional[float] = 1.0):
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(grace)
        self._server.server_close()


class MasterTransportClient:
    """Typed client for the two-RPC surface, with retry."""

    def __init__(self, addr: str, timeout_s: float = 30.0, retries: int = 10):
        self._addr = addr
        self._host, self._port = split_addr(addr)
        self._timeout = timeout_s
        self._retries = retries

    @property
    def addr(self) -> str:
        return self._addr

    def _once(self, body: bytes) -> bytes:
        with socket.create_connection((self._host, self._port),
                                      timeout=self._timeout) as s:
            send_frame(s, body)
            reply = recv_frame(s)
        if reply is None:
            raise ConnectionError("master closed the connection")
        return reply

    def call(self, method: bytes, payload: bytes,
             retries: Optional[int] = None) -> bytes:
        """One RPC (``method`` b"r" or b"g") on encoded message bytes;
        returns the reply message's bytes."""
        last_err: Optional[BaseException] = None
        retries = retries if retries is not None else self._retries
        for attempt in range(retries):
            try:
                reply = self._once(method + payload)
                break
            except (ConnectionError, socket.timeout, OSError) as e:
                # the master may be restarting; a refused, reset or
                # timed-out call is gRPC's UNAVAILABLE / DEADLINE_EXCEEDED
                last_err = e
                _wait(_backoff_delay(attempt))
        else:
            raise last_err  # type: ignore[misc]
        status, rest = reply[0], reply[1:]
        if status == UNPORTED:
            raise NotImplementedError(rest.decode())
        if status == ERROR:
            raise RemoteError(rest.decode())
        return rest

    def report(self, msg, retries: Optional[int] = None) -> bool:
        resp = msgs.deserialize(self.call(b"r", msgs.serialize(msg), retries))
        return bool(resp and resp.success)

    def get(self, msg, retries: Optional[int] = None):
        resp = msgs.deserialize(self.call(b"g", msgs.serialize(msg), retries))
        if isinstance(resp, msgs.Empty):
            return None
        return resp

    def close(self):
        pass


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
