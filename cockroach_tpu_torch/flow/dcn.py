"""Length-prefixed socket frames — the three framing functions of
``cockroach_tpu.flow.dcn`` that the changefeed and its fan-out plane use
(a little-endian u32 length, then the payload; length 0 ends a stream).
The rest of the reference module (the Arrow batch streams between hosts)
is not ported."""

from __future__ import annotations

import socket
import struct

_LEN = struct.Struct("<I")


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Exactly n bytes; the deadline is the socket's own timeout, which
    every caller sets (dials pass it to create_connection, servers set it
    before the handshake read)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("flow stream closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> bytes | None:
    n = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    if n == 0:
        return None
    return _recv_exact(sock, n)
