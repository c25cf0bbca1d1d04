"""Blocking loopback client for the gateway — stdlib ``http.client``.

Counterpart of :mod:`jaxstream.gateway.client`, whose code this module
keeps as it is (pure Python in both packages; the port keeps its own
copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

The loadgen harness and the tests drive the asyncio gateway from plain
worker threads; this module gives them a dependency-free client that
understands the NDJSON streaming protocol (:mod:`.protocol`).  One
call = one connection = one request's full event stream, mirroring the
server's one-writer-per-connection invariant on the read side.
"""

from __future__ import annotations

import base64
import hashlib
import http.client
import json
import os
import socket
import struct
from typing import Callable, List, Optional, Tuple

from . import protocol

__all__ = ["GatewayError", "submit_streaming", "submit_websocket",
           "get_json", "get_text", "post_json", "final_result"]


class GatewayError(RuntimeError):
    """A non-200 admission response.  ``status`` is the HTTP status,
    ``error`` the typed protocol code (``queue_full``/``draining``/...),
    so callers can tell backpressure (429) from unavailability (503)
    without string matching."""

    def __init__(self, status: int, body: dict):
        self.status = int(status)
        self.error = body.get("error", "internal")
        self.body = body
        super().__init__(
            f"gateway returned {status} ({self.error}): "
            f"{body.get('message', '')}")


def submit_streaming(host: str, port: int, request: dict,
                     timeout: float = 300.0,
                     on_event: Optional[Callable] = None,
                     ) -> Tuple[int, List[dict]]:
    """POST one request; read its NDJSON stream to the final event.

    Returns ``(http_status, events)`` where ``events`` is the full
    ordered stream (``accepted`` ... ``segment``* ... ``result``).
    ``on_event`` is called with each event as it arrives (the drain
    test uses it to act mid-flight).  Raises :class:`GatewayError` on a
    typed non-200 admission response.
    """
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/v1/requests", body=json.dumps(request),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            body = json.loads(resp.read().decode("utf-8"))
            raise GatewayError(resp.status, body)
        events: List[dict] = []
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line.decode("utf-8"))
            events.append(ev)
            if on_event is not None:
                on_event(ev)
            if ev.get("event") in ("result", "error"):
                break
        return resp.status, events
    finally:
        conn.close()


def get_json(host: str, port: int, path: str,
             timeout: float = 30.0) -> Tuple[int, dict]:
    """GET one JSON endpoint (health/ready/stats)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode("utf-8"))
    finally:
        conn.close()


def get_text(host: str, port: int, path: str,
             timeout: float = 30.0) -> Tuple[int, str, str]:
    """GET one text endpoint (``/v1/metrics``).  Returns
    ``(status, content_type, body)`` — the Prometheus exposition is
    plain text, not JSON, so :func:`get_json` cannot fetch it."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Content-Type", ""),
                resp.read().decode("utf-8"))
    finally:
        conn.close()


def post_json(host: str, port: int, path: str, body: dict,
              timeout: float = 30.0) -> Tuple[int, dict]:
    """POST one JSON control endpoint (``/v1/profile``)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode("utf-8"))
    finally:
        conn.close()


def final_result(events: List[dict]):
    """The decoded :class:`RequestResult` of a completed stream (None
    when the stream ended in an error event)."""
    for ev in reversed(events):
        if ev.get("event") == "result":
            return protocol.decode_result(ev)
    return None


# ------------------------------------------------------------- WebSocket
_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("WebSocket closed mid-frame")
        buf += chunk
    return bytes(buf)


def _ws_send(sock: socket.socket, opcode: int, payload: bytes) -> None:
    """One masked client frame (RFC 6455 section 5.3)."""
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", 0x80 | opcode, 0x80 | n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", 0x80 | opcode, 0x80 | 126, n)
    else:
        head = struct.pack("!BBQ", 0x80 | opcode, 0x80 | 127, n)
    key = os.urandom(4)
    body = bytes(b ^ key[i & 3] for i, b in enumerate(payload))
    sock.sendall(head + key + body)


def _ws_recv(sock: socket.socket) -> Tuple[int, bytes]:
    """One whole server message (continuations joined)."""
    parts, first = [], None
    while True:
        b0, b1 = _recv_exact(sock, 2)
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack("!H", _recv_exact(sock, 2))[0]
        elif n == 127:
            n = struct.unpack("!Q", _recv_exact(sock, 8))[0]
        key = _recv_exact(sock, 4) if b1 & 0x80 else None
        data = _recv_exact(sock, n)
        if key is not None:
            data = bytes(b ^ key[i & 3] for i, b in enumerate(data))
        opcode = b0 & 0x0F
        if opcode >= 0x8:
            return opcode, data
        parts.append(data)
        first = opcode if first is None else first
        if b0 & 0x80:
            return first, b"".join(parts)


def submit_websocket(host: str, port: int, request: dict,
                     timeout: float = 300.0) -> List[dict]:
    """Submit one request over ``GET /v1/ws`` and read its events to the
    final one: the same ordered stream :func:`submit_streaming` returns
    (``accepted`` ... ``segment``* ... ``result``), or a lone typed
    ``error`` event for a refused admission.  Stdlib sockets: the
    upgrade handshake, masked text frames out, a close frame at the
    end."""
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((
            f"GET /v1/ws HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").encode("ascii"))
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = sock.recv(1)
            if not chunk:
                raise ConnectionError("WebSocket handshake: connection "
                                      "closed")
            head += chunk
        lines = head.decode("latin-1").split("\r\n")
        if " 101 " not in lines[0] + " ":
            raise ConnectionError(f"WebSocket handshake refused: "
                                  f"{lines[0]!r}")
        want = base64.b64encode(hashlib.sha1(
            (key + _WS_GUID).encode("ascii")).digest()).decode("ascii")
        hdrs = {ln.partition(":")[0].strip().lower():
                ln.partition(":")[2].strip() for ln in lines[1:] if ln}
        if hdrs.get("sec-websocket-accept") != want:
            raise ConnectionError("WebSocket handshake: bad "
                                  "Sec-WebSocket-Accept")
        _ws_send(sock, 0x1, json.dumps(request).encode("utf-8"))
        events: List[dict] = []
        while True:
            opcode, data = _ws_recv(sock)
            if opcode == 0x8:
                break
            if opcode != 0x1:
                continue
            ev = json.loads(data.decode("utf-8"))
            events.append(ev)
            if ev.get("event") in ("result", "error"):
                break
        try:
            _ws_send(sock, 0x8, struct.pack("!H", 1000))
        except OSError:
            pass
    return events
