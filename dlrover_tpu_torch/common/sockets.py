"""Shared low-level socket helpers for the framed-TCP services.

Port of ``dlrover_tpu/common/sockets.py``: the exact-read loop of the
data planes (``recv_into`` over a memoryview in bounded chunks, with a
cap so a desynced or hostile peer cannot make a reader allocate a
buffer of its choosing) and the connection-auth preamble that every
data plane speaks before its first frame.

The preamble and the framing are the JAX package's byte for byte
(``tests/test_torch_replica.py`` runs the two packages' replica rings
against each other): the magic ``\\x00DTPAUTH``, the token's length as 4
little-endian bytes, the token. It is always sent and always read; a
server with no token only skips the comparison, so a client and a
server that disagree about auth fail at the handshake instead of
desyncing the stream. The token is ``DLROVER_TPU_WIRE_TOKEN`` (the
job-wide secret), else ``DLROVER_TPU_RUN_ID``: every host of a run
shares it.
"""

import hmac
import os
import socket
from typing import Optional

from dlrover_tpu_torch.common.log import get_logger

# Starts with NUL so a peer with a token on one side only can never
# alias a legitimate op byte in any of the framed protocols.
_AUTH_MAGIC = b"\x00DTPAUTH"
_MAX_TOKEN = 4096
_CHUNK = 1 << 20

# Nothing legitimately frames more than a checkpoint pack; anything
# larger is a desynced stream or garbage.
MAX_FRAME_BYTES = 1 << 31

_warned_fallback_token = False


def default_token() -> str:
    """The run-shared wire token (empty: token comparison disabled).

    ``DLROVER_TPU_WIRE_TOKEN`` is the real credential; the
    ``DLROVER_TPU_RUN_ID`` fallback is often predictable (the job name),
    so it only keeps strays out, and a warning says so once."""
    tok = os.environ.get("DLROVER_TPU_WIRE_TOKEN")
    if tok:
        return tok
    run_id = os.environ.get("DLROVER_TPU_RUN_ID", "")
    global _warned_fallback_token
    if run_id and not _warned_fallback_token:
        _warned_fallback_token = True
        get_logger(__name__).warning(
            "wire auth is using the DLROVER_TPU_RUN_ID fallback (a "
            "predictable value); set a random DLROVER_TPU_WIRE_TOKEN for "
            "real protection")
    return run_id


def send_auth(sock: socket.socket, token: Optional[str]) -> None:
    """Client side: send the preamble (always: an empty token sends the
    magic and length 0)."""
    raw = (token or "").encode("utf-8")
    sock.sendall(_AUTH_MAGIC + len(raw).to_bytes(4, "little") + raw)


def check_auth(sock: socket.socket, token: Optional[str]) -> bool:
    """Server side: read and check the preamble before any frame. The
    magic is always required; the token is compared only when the server
    has one. On False the caller closes without answering."""
    try:
        if bytes(recv_exact(sock, len(_AUTH_MAGIC))) != _AUTH_MAGIC:
            return False
        n = int.from_bytes(bytes(recv_exact(sock, 4)), "little")
        if not 0 <= n <= _MAX_TOKEN:
            return False
        got = bytes(recv_exact(sock, n)) if n else b""
    except (ConnectionError, OSError):
        return False
    if not token:
        return True
    # bytes, not str: compare_digest raises on non-ASCII str
    return hmac.compare_digest(got, token.encode("utf-8"))


def recv_exact(sock: socket.socket, n: int,
               max_bytes: Optional[int] = MAX_FRAME_BYTES) -> bytearray:
    """Read exactly ``n`` bytes or raise ConnectionError; an ``n`` that is
    negative or past ``max_bytes`` (a desynced stream) raises too."""
    if n < 0 or (max_bytes is not None and n > max_bytes):
        raise ConnectionError(f"invalid frame length {n}")
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, _CHUNK))
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return buf
