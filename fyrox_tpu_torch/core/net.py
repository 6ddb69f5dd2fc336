"""Length-prefixed TCP message framing.

Equivalent of fyrox-core/src/net.rs: a non-blocking TcpListener
(NetListener, net.rs:29) and a message stream (NetStream, net.rs:53) that
frames each message as ``u32 little-endian length + payload``, drains the
socket into an rx buffer, and pops complete messages. The reference
serializes with bincode; here the default codec is msgpack-free JSON
(UTF-8) with a raw-bytes escape hatch — peers on the Python side agree on
the codec, the FRAMING on the wire is byte-identical to the reference's.
"""
from __future__ import annotations

import errno
import json
import socket
import struct
from typing import Any, Callable, List, Optional

from fyrox_tpu_torch.core.log import Log

__all__ = ["NetListener", "NetStream"]

_LEN = struct.Struct("<I")        # u32 little-endian length prefix


def _encode(data: Any) -> bytes:
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    return json.dumps(data).encode("utf-8")


def _decode(blob: bytes, raw: bool):
    if raw:
        return blob
    return json.loads(blob.decode("utf-8"))


class NetListener:
    """Non-blocking TCP listener (net.rs:29 NetListener)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock

    @classmethod
    def bind(cls, addr) -> "NetListener":
        host, port = addr if isinstance(addr, tuple) else (addr, 0)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen()
        s.setblocking(False)
        return cls(s)

    def local_address(self):
        return self._sock.getsockname()

    def accept_connections(self) -> List["NetStream"]:
        """Drain every pending connection (net.rs:44)."""
        streams = []
        while True:
            try:
                conn, _ = self._sock.accept()
            except (BlockingIOError, InterruptedError):
                break
            streams.append(NetStream.from_inner(conn))
        return streams

    def close(self):
        self._sock.close()


class NetStream:
    """Framed non-blocking message stream (net.rs:53 NetStream)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._rx = bytearray()

    @classmethod
    def from_inner(cls, sock: socket.socket) -> "NetStream":
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return cls(sock)

    @classmethod
    def connect(cls, addr) -> "NetStream":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.connect(addr)               # blocking connect, like the reference
        return cls.from_inner(s)

    def peer_address(self):
        return self._sock.getpeername()

    def string_peer_address(self) -> str:
        try:
            host, port = self.peer_address()
            return f"{host}:{port}"
        except OSError:
            return "Unknown"

    def send_message(self, data: Any) -> None:
        """u32-LE length + payload (net.rs:75 send_message)."""
        blob = _encode(data)
        self._sock.sendall(_LEN.pack(len(blob)) + blob)

    # -- receive side --------------------------------------------------------
    def _receive_bytes(self) -> None:
        """Drain the socket into the rx buffer (net.rs:138)."""
        while True:
            try:
                chunk = self._sock.recv(8192)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as err:
                if err.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                Log.err(f"socket read error: {err}")
                self._rx.clear()
                return
            if not chunk:
                break
            self._rx.extend(chunk)

    def _next_message(self, raw: bool):
        if len(self._rx) < 4:
            return None
        (length,) = _LEN.unpack(bytes(self._rx[:4]))
        end = 4 + length
        if len(self._rx) < end:
            return None               # not fully delivered yet (net.rs:118)
        blob = bytes(self._rx[4:end])
        del self._rx[:end]
        try:
            return _decode(blob, raw)
        except ValueError as err:
            Log.err(f"failed to parse a network message of {length} bytes "
                    f"long: {err}")
            return None

    def pop_message(self, raw: bool = False) -> Optional[Any]:
        self._receive_bytes()
        return self._next_message(raw)

    def process_input(self, func: Callable[[Any], None],
                      raw: bool = False) -> None:
        """Drain the socket and call func on every complete message
        (net.rs:171 process_input)."""
        self._receive_bytes()
        while True:
            msg = self._next_message(raw)
            if msg is None:
                return
            func(msg)

    def close(self):
        self._sock.close()
