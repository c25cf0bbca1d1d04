"""The network front door over :class:`EnsembleServer`, on the standard
library (counterpart of :mod:`jaxstream.gateway.gateway`).

The JAX gateway is an aiohttp application; the machine with the GPU has
no aiohttp, so this one is ``asyncio.start_server`` with a small
HTTP/1.1 reader and RFC 6455 WebSocket framing of its own.  It serves
the JAX routes with the same statuses and bodies:

* ``POST /v1/requests`` admits a scenario request and streams its
  events back as NDJSON (chunked transfer) on the same connection;
* ``GET /v1/ws`` speaks the identical events over a WebSocket (the
  ``Sec-WebSocket-Accept`` handshake, masked client text frames, close
  and ping frames), one in-flight request per connection;
* ``GET /v1/health``, ``/v1/ready``, ``/v1/stats`` (JSON) and
  ``/v1/metrics`` (Prometheus text);
* ``POST /v1/profile`` starts or stops a ``torch.profiler`` capture
  that writes a Chrome trace under ``profile_dir`` (501 without one,
  409 on start-while-running or stop-while-idle).  The profiler records
  the thread that starts it, so the serving thread runs the start and
  the stop at its next segment boundary or idle tick, and the handler
  waits for it.

Three threads, as in the JAX design: the HTTP loop
(``jaxstream-gateway-http``) touches bytes only; the serving thread
(``jaxstream-gateway-serve``) runs :meth:`EnsembleServer.serve_forever`
and is the only thread that launches GPU work; the server's result
writer finalizes results.  **One writer per connection**: every
connection's events flow through a per-request ``asyncio.Queue`` that
server threads feed only through ``loop.call_soon_threadsafe``, and
the server emits a request's segment events before queueing its
finalization, so a stream never sees ``result`` before its last
``segment``.  Overload is typed (429 ``queue_full``, 503 ``draining``
/ ``admission_refused``), drain is graceful (admissions stop, in-flight
members finish, nothing is re-queued), and the gateway binds loopback
addresses only.  Each HTTP connection carries one request and closes
after its response (``Connection: close``).
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import hashlib
import ipaddress
import json
import os
import queue
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from ..config import Config, load_config
from ..obs import flight
from ..obs import trace as obs_trace
from ..obs.registry import CONTENT_TYPE as _PROM_CONTENT_TYPE
from ..obs.sink import TelemetrySink, run_manifest
from ..serve.queue import AdmissionRefused, QueueFull, ServerDraining
from ..serve.request import RequestResult, ScenarioRequest
from ..serve.server import EnsembleServer
from ..utils.logging import get_logger
from . import protocol

__all__ = ["Gateway", "GATEWAY_HTTP_THREAD_NAME",
           "GATEWAY_SERVE_THREAD_NAME", "WS_GUID", "ws_accept_key"]

log = get_logger(__name__)

GATEWAY_HTTP_THREAD_NAME = "jaxstream-gateway-http"
GATEWAY_SERVE_THREAD_NAME = "jaxstream-gateway-serve"

#: Sentinel closing every live stream when the loop is torn down
#: without a result (hard shutdown).
_SHUTDOWN_EVENT = protocol.error_event(
    "shutdown", "gateway shut down before the request completed")

#: RFC 6455's handshake GUID.
WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

_REASONS = {101: "Switching Protocols", 200: "OK", 400: "Bad Request",
            404: "Not Found", 405: "Method Not Allowed",
            409: "Conflict", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable"}

_JSON_TYPE = "application/json; charset=utf-8"
#: Largest request body read (an ``ic: 'array'`` state at C384 is about
#: 14 MB of base64).
MAX_BODY_BYTES = 256 * 1024 * 1024
_MAX_HEADER_LINES = 100

_ROUTES = {"/v1/requests": "POST", "/v1/ws": "GET",
           "/v1/health": "GET", "/v1/ready": "GET", "/v1/stats": "GET",
           "/v1/metrics": "GET", "/v1/profile": "POST"}


def ws_accept_key(key: str) -> str:
    """The ``Sec-WebSocket-Accept`` value of a client's
    ``Sec-WebSocket-Key`` (RFC 6455 section 4.2.2)."""
    digest = hashlib.sha1((key + WS_GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _is_loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


class _BadRequest(Exception):
    """A request the HTTP reader cannot parse (answered with 400)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Request:
    """One parsed HTTP request: method, path, lower-cased headers, body."""

    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body


async def _read_request(reader: asyncio.StreamReader) -> Optional[_Request]:
    """Read one HTTP/1.1 request; None on a connection closed before a
    request line."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise _BadRequest(400, f"bad request line {line[:80]!r}") from None
    if not version.startswith("HTTP/1."):
        raise _BadRequest(400, f"unsupported protocol {version!r}")
    headers: Dict[str, str] = {}
    for _ in range(_MAX_HEADER_LINES):
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest(400, f"bad header line {h[:80]!r}")
        headers[name.strip().lower()] = value.strip()
    else:
        raise _BadRequest(400, "too many header lines")
    body = b""
    if "chunked" in headers.get("transfer-encoding", "").lower():
        parts = []
        total = 0
        while True:
            size_line = await reader.readline()
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise _BadRequest(400, "bad chunk size") from None
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n",
                                                        b""):
                    pass
                break
            total += size
            if total > MAX_BODY_BYTES:
                raise _BadRequest(413, "request body too large")
            parts.append(await reader.readexactly(size))
            await reader.readline()
        body = b"".join(parts)
    elif "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise _BadRequest(400, "bad Content-Length") from None
        if n < 0 or n > MAX_BODY_BYTES:
            raise _BadRequest(413, "request body too large")
        body = await reader.readexactly(n)
    path = target.split("?", 1)[0]
    return _Request(method.upper(), path, headers, body)


def _head(status: int, headers) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _respond(writer: asyncio.StreamWriter, status: int, body: bytes,
                   content_type: str) -> None:
    writer.write(_head(status, [("Content-Type", content_type),
                                ("Content-Length", str(len(body))),
                                ("Connection", "close")]) + body)
    await writer.drain()


async def _respond_json(writer, payload: dict, status: int = 200) -> None:
    await _respond(writer, status, json.dumps(payload).encode("utf-8"),
                   _JSON_TYPE)


# ------------------------------------------------------------- WebSocket
async def _ws_read(reader: asyncio.StreamReader):
    """One client frame: ``(opcode, unmasked payload, fin)``.  Client frames
    must be masked (RFC 6455 section 5.1)."""
    b0, b1 = await reader.readexactly(2)
    opcode = b0 & 0x0F
    masked = b1 & 0x80
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
    if n > MAX_BODY_BYTES:
        raise _BadRequest(413, "WebSocket frame too large")
    if not masked:
        raise _BadRequest(400, "client WebSocket frames must be masked")
    key = await reader.readexactly(4)
    data = bytearray(await reader.readexactly(n))
    for i in range(n):
        data[i] ^= key[i & 3]
    return opcode, bytes(data), bool(b0 & 0x80)


async def _ws_message(reader) -> Tuple[int, bytes]:
    """One whole message (continuation frames joined); control frames
    come back as they are, between a message's fragments too."""
    opcode, data, fin = await _ws_read(reader)
    if opcode >= 0x8 or fin:
        return opcode, data
    parts = [data]
    while True:
        op, more, fin = await _ws_read(reader)
        if op >= 0x8:
            return op, more
        parts.append(more)
        if fin:
            return opcode, b"".join(parts)


def _ws_frame(opcode: int, payload: bytes) -> bytes:
    """An unmasked server frame."""
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", 0x80 | opcode, n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", 0x80 | opcode, 126, n)
    else:
        head = struct.pack("!BBQ", 0x80 | opcode, 127, n)
    return head + payload


class Gateway:
    """Asyncio HTTP/WebSocket front end over one :class:`EnsembleServer`.

    ``config`` is the config surface (the server's ``serve:`` block
    included); ``device`` where the server runs (default: the GPU).
    ``host`` must be a loopback address; ``port=0`` binds an ephemeral
    port, published as :attr:`port` once :meth:`start` returns.
    ``autoscale`` is an optional ``tick(server)`` evaluated at segment
    boundaries (:class:`jaxstream_torch.loadgen.autoscale.
    AutoscaleController`); ``sink`` names a JSONL file for the
    per-request ``gateway`` records.  Use as a context manager, or call
    :meth:`close` when done.
    """

    def __init__(self, config=None, *, host: str = "127.0.0.1",
                 port: int = 0, autoscale=None, warm: bool = True,
                 sink: str = "", idle_wait: float = 0.005,
                 profile_dir: str = "", device=None):
        if not _is_loopback(host):
            raise ValueError(
                f"Gateway binds loopback addresses only, got {host!r} "
                "(put a reverse proxy in front for other interfaces)")
        self.config: Config = load_config(config)
        self._host = host
        self._requested_port = int(port)
        self.port: Optional[int] = None
        self._idle_wait = float(idle_wait)
        self._autoscale = autoscale
        self._profile_dir = profile_dir
        self._profiler = None
        self._profiler_thread: Optional[int] = None
        self._profile_cmds: "queue.Queue" = queue.Queue()
        self._profiles = 0
        self.server = EnsembleServer(self.config,
                                     on_result=self._on_result,
                                     on_segment=self._on_segments,
                                     device=device)
        self.metrics = self.server.metrics
        self._trace_on = bool(self.config.serve.trace)
        if warm:
            self.server.warmup()
        if autoscale is not None:
            autoscale.attach(self.server)
        #: compile count after warm-up: the zero-steady-state-build
        #: assertion surface for the whole gateway (resizes included).
        self.warm_compiles = self.server.compile_count()
        self.stats = {"submitted": 0, "completed": 0, "evicted": 0,
                      "shed_queue_full": 0, "shed_draining": 0,
                      "shed_admission": 0, "bad_requests": 0,
                      "ws_connections": 0}
        self._streams: Dict[str, asyncio.Queue] = {}
        self._streams_lock = threading.Lock()
        self._sink = None
        self._sink_lock = threading.Lock()
        if sink:
            self._sink = TelemetrySink(sink, run_manifest(config={
                "gateway": True, "host": host,
                "grid_n": self.config.grid.n,
                "buckets": list(self.server.buckets),
                "queue_capacity": self.config.serve.queue_capacity,
            }, device=self.server.device))
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_stop: Optional[asyncio.Event] = None
        self._conns: set = set()
        self._ready = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._http_thread: Optional[threading.Thread] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._started = False
        self._closed = False
        self._t0 = time.perf_counter()

    # ---------------------------------------------------------- lifecycle
    def start(self, serve: bool = True) -> "Gateway":
        """Bind the HTTP endpoint (and start the serving loop).
        ``serve=False`` binds the front end without draining the queue:
        the deterministic way to test admission backpressure."""
        if self._started:
            raise RuntimeError("Gateway.start() called twice")
        self._started = True
        self._http_thread = threading.Thread(
            target=self._run_http, name=GATEWAY_HTTP_THREAD_NAME,
            daemon=True)
        self._http_thread.start()
        if not self._ready.wait(timeout=60):
            raise RuntimeError("gateway HTTP endpoint failed to bind "
                               "within 60s")
        if self._boot_error is not None:
            raise RuntimeError(
                "gateway HTTP endpoint failed to start"
            ) from self._boot_error
        if serve:
            self._serve_thread = threading.Thread(
                target=self._run_serve, name=GATEWAY_SERVE_THREAD_NAME,
                daemon=True)
            self._serve_thread.start()
        return self

    def __enter__(self):
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self.server.draining

    def begin_drain(self) -> None:
        """Stop admissions NOW (new submits -> 503 ``draining``); the
        serving loop runs until every admitted request has reached its
        own final step, then exits."""
        self.server.begin_drain()

    def drain(self, timeout: Optional[float] = 120) -> None:
        """:meth:`begin_drain`, then wait for in-flight work to finish
        and the result writer and sinks to flush."""
        self.begin_drain()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout)
            if self._serve_thread.is_alive():
                raise RuntimeError(
                    f"gateway drain did not complete within {timeout}s")

    def close(self, drain: bool = True) -> None:
        """Drain (by default), stop the serving loop, tear down the HTTP
        endpoint, close the server and the gateway sink."""
        if self._closed:
            return
        self._closed = True
        try:
            if drain and self._serve_thread is not None:
                self.drain()
        finally:
            self._stop.set()
            if self._serve_thread is not None:
                self._serve_thread.join(30)
            with self._streams_lock:
                pending = list(self._streams)
            for rid in pending:
                self._post(rid, dict(_SHUTDOWN_EVENT, id=rid))
            if self._loop is not None and self._loop.is_running():
                self._loop.call_soon_threadsafe(self._loop_stop.set)
            if self._http_thread is not None:
                self._http_thread.join(30)
            self.server.close()
            if self._sink is not None:
                self._sink.close()

    # ------------------------------------------------------ event plumbing
    def _post(self, rid: str, event: dict) -> None:
        """Enqueue one event onto a request's stream, from any thread."""
        with self._streams_lock:
            q = self._streams.get(rid)
        loop = self._loop
        if q is None or loop is None or not loop.is_running():
            return
        loop.call_soon_threadsafe(q.put_nowait, event)

    def _on_segments(self, events) -> None:
        """Serving thread: the server's per-segment progress events."""
        for ev in events:
            self._post(ev["id"], protocol.segment_event(ev))

    def _on_result(self, res: RequestResult) -> None:
        """Writer thread: a request reached its final state."""
        self.stats["completed" if res.ok else "evicted"] += 1
        rec = {"kind": "gateway", "id": res.id, "ic": res.ic,
               "status": res.status,
               "latency_s": round(res.latency_s, 6),
               "steps_run": res.steps_run,
               "nsteps": res.nsteps}
        if self._trace_on:
            tid = obs_trace.trace_id_for(res.id)
            rec.update(trace_id=tid,
                       span_id=obs_trace.root_span_id(tid),
                       parent_id=None)
        self._record(rec)
        # Encode only while a connection is subscribed.
        with self._streams_lock:
            subscribed = res.id in self._streams
        if subscribed:
            t_eg = time.perf_counter()
            self._post(res.id, protocol.result_event(res))
            if self._trace_on:
                tid = obs_trace.trace_id_for(res.id)
                self._record({
                    "kind": "span", "trace_id": tid,
                    "span_id": obs_trace.span_id_for(
                        tid, obs_trace.GATEWAY_EGRESS, 0),
                    "parent_id": obs_trace.root_span_id(tid),
                    "id": res.id, "name": obs_trace.GATEWAY_EGRESS,
                    "seq": 0,
                    "start_s": round(res.latency_s, 6),
                    "duration_s": round(
                        time.perf_counter() - t_eg, 6)})

    def _record(self, rec: dict) -> None:
        if self._sink is None:
            return
        with self._sink_lock:
            try:
                self._sink.write(rec)
            except Exception as e:  # telemetry must never kill serving
                log.warning("gateway sink write failed (%s: %s)",
                            type(e).__name__, e)

    # ---------------------------------------------------------- admission
    def submit(self, req: ScenarioRequest) -> None:
        """Admit one request (the network handlers' shared path); raises
        the typed serve exceptions."""
        t = self._serve_thread
        if t is not None and not t.is_alive() and not self._closed:
            raise AdmissionRefused(
                f"gateway refused {req.id!r}: the serving loop has "
                "stopped; this deployment cannot serve new traffic")
        self.server.submit(req)
        self.stats["submitted"] += 1

    def _shed(self, req_id: str, code: str, message: str,
              started_at: Optional[float] = None) -> dict:
        key = protocol.SHED_STATUS.get(code)
        if key is not None:
            flight.record("gateway.shed", id=req_id, code=code)
            self.stats[key] += 1
            self.metrics.counter_inc("jaxstream_requests_shed_total",
                                     status=key)
            rec = {"kind": "gateway", "id": req_id, "ic": "",
                   "status": key, "latency_s": 0.0, "error": code}
            if self._trace_on:
                tid = obs_trace.trace_id_for(req_id)
                rec.update(trace_id=tid,
                           span_id=obs_trace.root_span_id(tid),
                           parent_id=None)
            self._record(rec)
            if self._trace_on:
                self._record(obs_trace.terminal_span(
                    req_id, key,
                    duration_s=(time.perf_counter() - started_at
                                if started_at is not None else 0.0)))
        return protocol.error_event(code, message, rid=req_id)

    def _admit_or_error(self, body, started_at: Optional[float] = None):
        """Parse + admit; returns (req, None) or (None, (event, status))."""
        t_in0 = time.perf_counter() if started_at is None else started_at
        try:
            req = protocol.request_from_json(body)
        except ValueError as e:
            self.stats["bad_requests"] += 1
            return None, (protocol.error_event("bad_request", str(e)),
                          400)
        with self._streams_lock:
            if req.id in self._streams:
                self.stats["bad_requests"] += 1
                return None, (protocol.error_event(
                    "duplicate_id",
                    f"request id {req.id!r} is already in flight on "
                    "this gateway", rid=req.id), 409)
            self._streams[req.id] = asyncio.Queue()
        try:
            self.submit(req)
        except QueueFull as e:
            self._drop_stream(req.id)
            return None, (self._shed(req.id, "queue_full", str(e),
                                     t_in0), 429)
        except ServerDraining as e:
            self._drop_stream(req.id)
            return None, (self._shed(req.id, "draining", str(e),
                                     t_in0), 503)
        except AdmissionRefused as e:
            self._drop_stream(req.id)
            return None, (self._shed(req.id, "admission_refused",
                                     str(e), t_in0), 503)
        except ValueError as e:
            # Deployment-level validation (an ic 'array' state of the
            # wrong shape or dtype): a caller bug, typed 400.
            self._drop_stream(req.id)
            self.stats["bad_requests"] += 1
            return None, (protocol.error_event(
                "bad_request", str(e), rid=req.id), 400)
        except Exception as e:
            self._drop_stream(req.id)
            log.warning("gateway: submit of %r failed (%s: %s)",
                        req.id, type(e).__name__, e)
            return None, (protocol.error_event(
                "internal", f"{type(e).__name__}: {e}", rid=req.id),
                500)
        if self._trace_on:
            tid = obs_trace.trace_id_for(req.id)
            t_adm = time.perf_counter()
            self._record({
                "kind": "span", "trace_id": tid,
                "span_id": obs_trace.span_id_for(
                    tid, obs_trace.GATEWAY_INGRESS, 0),
                "parent_id": obs_trace.root_span_id(tid),
                "id": req.id, "name": obs_trace.GATEWAY_INGRESS,
                "seq": 0,
                "start_s": round(t_in0 - req.submitted_wall, 6),
                "duration_s": round(t_adm - t_in0, 6)})
        return req, None

    def _drop_stream(self, rid: str) -> None:
        with self._streams_lock:
            self._streams.pop(rid, None)

    # --------------------------------------------------------- HTTP layer
    def _run_http(self) -> None:
        try:
            asyncio.run(self._amain())
        except BaseException as e:  # pragma: no cover - boot failures
            self._boot_error = e
            self._ready.set()

    async def _amain(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._loop_stop = asyncio.Event()
        srv = await asyncio.start_server(
            self._handle_conn, self._host, self._requested_port,
            limit=1 << 20)
        self.port = srv.sockets[0].getsockname()[1]
        self._ready.set()
        log.info("gateway: listening on %s", self.url)
        try:
            await self._loop_stop.wait()
        finally:
            self._drop_profiler()
            srv.close()
            for task in list(self._conns):
                task.cancel()
            if self._conns:
                await asyncio.wait(list(self._conns), timeout=10)

    def _serving_tick(self, server) -> None:
        """The serving thread's boundary hook: pending profiler commands,
        then the autoscale tick."""
        self._run_profile_cmds()
        if self._autoscale is not None:
            self._autoscale(server)

    def _run_serve(self) -> None:
        try:
            self.server.serve_forever(stop=self._stop,
                                      idle_wait=self._idle_wait,
                                      tick=self._serving_tick)
        except BaseException:
            log.exception("gateway serving loop died")
        finally:
            self._run_profile_cmds()
            self._drop_profiler()
            # No segment or result can arrive any more: end every
            # waiting stream with a typed error, not a hang.
            with self._streams_lock:
                pending = list(self._streams)
            for rid in pending:
                self._post(rid, protocol.error_event(
                    "internal", "serving loop stopped before the "
                    "request completed", rid=rid))

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """One connection, one request: this coroutine is the
        connection's only writer."""
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            try:
                req = await _read_request(reader)
            except _BadRequest as e:
                self.stats["bad_requests"] += 1
                await _respond_json(writer, protocol.error_event(
                    "bad_request", str(e)), status=e.status)
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            if req is None:
                return
            want = _ROUTES.get(req.path)
            if want is None:
                await _respond(writer, 404, b"404: Not Found",
                               "text/plain; charset=utf-8")
                return
            if req.method != want:
                await _respond(writer, 405, b"405: Method Not Allowed",
                               "text/plain; charset=utf-8")
                return
            handler = {
                "/v1/requests": self._handle_submit,
                "/v1/ws": self._handle_ws,
                "/v1/health": self._handle_health,
                "/v1/ready": self._handle_ready,
                "/v1/stats": self._handle_stats,
                "/v1/metrics": self._handle_metrics,
                "/v1/profile": self._handle_profile,
            }[req.path]
            await handler(req, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.warning("gateway: connection handler failed (%s: %s)",
                        type(e).__name__, e)
        finally:
            self._conns.discard(task)
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _body_json(req: _Request):
        return json.loads(req.body.decode("utf-8"))

    async def _handle_submit(self, req: _Request, reader, writer):
        """POST /v1/requests: admit, then stream NDJSON events (chunked)
        until the final result."""
        t_in0 = time.perf_counter()
        try:
            body = self._body_json(req)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self.stats["bad_requests"] += 1
            await _respond_json(writer, protocol.error_event(
                "bad_request", f"body is not JSON: {e}"), status=400)
            return
        sreq, err = self._admit_or_error(body, started_at=t_in0)
        if err is not None:
            await _respond_json(writer, err[0], status=err[1])
            return
        with self._streams_lock:
            q = self._streams[sreq.id]
        try:
            writer.write(_head(200, [
                ("Content-Type", "application/x-ndjson"),
                ("Transfer-Encoding", "chunked"),
                ("Connection", "close")]))
            ev = protocol.accepted_event(sreq.id)
            while True:
                line = (json.dumps(ev) + "\n").encode("utf-8")
                writer.write(f"{len(line):x}\r\n".encode("ascii") + line
                             + b"\r\n")
                await writer.drain()
                if ev["event"] in ("result", "error"):
                    break
                ev = await q.get()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            self._drop_stream(sreq.id)

    async def _handle_ws(self, req: _Request, reader, writer):
        """GET /v1/ws: the same protocol over a WebSocket, one in-flight
        request per connection (the next message is read only after the
        previous stream's final event)."""
        key = req.headers.get("sec-websocket-key", "")
        if ("websocket" not in req.headers.get("upgrade", "").lower()
                or not key):
            await _respond(writer, 400,
                           b"400: Bad Request (expected a WebSocket "
                           b"upgrade)", "text/plain; charset=utf-8")
            return
        writer.write(_head(101, [("Upgrade", "websocket"),
                                 ("Connection", "Upgrade"),
                                 ("Sec-WebSocket-Accept",
                                  ws_accept_key(key))]))
        await writer.drain()
        self.stats["ws_connections"] += 1

        async def send(ev: dict):
            writer.write(_ws_frame(0x1, json.dumps(ev).encode("utf-8")))
            await writer.drain()

        while True:
            try:
                opcode, data = await _ws_message(reader)
            except _BadRequest:
                break
            if opcode == 0x9:                       # ping -> pong
                writer.write(_ws_frame(0xA, data))
                await writer.drain()
                continue
            if opcode == 0xA:                       # unsolicited pong
                continue
            if opcode != 0x1:                       # close, binary
                break
            t_in0 = time.perf_counter()
            try:
                body = json.loads(data.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                await send(protocol.error_event(
                    "bad_request", f"message is not JSON: {e}"))
                continue
            sreq, err = self._admit_or_error(body, started_at=t_in0)
            if err is not None:
                await send(err[0])
                continue
            with self._streams_lock:
                q = self._streams[sreq.id]
            try:
                await send(protocol.accepted_event(sreq.id))
                while True:
                    ev = await q.get()
                    await send(ev)
                    if ev["event"] in ("result", "error"):
                        break
            finally:
                self._drop_stream(sreq.id)
        writer.write(_ws_frame(0x8, struct.pack("!H", 1000)))
        await writer.drain()

    async def _handle_health(self, req, reader, writer):
        """Liveness: the process is up and the serving thread (when
        started) has not died."""
        serving = (self._serve_thread is not None
                   and self._serve_thread.is_alive())
        ok = self._serve_thread is None or serving
        await _respond_json(writer, {
            "status": "ok" if ok else "serving_thread_dead",
            "serving_thread_alive": serving,
            "uptime_s": round(time.perf_counter() - self._t0, 3),
        }, status=200 if ok else 503)

    async def _handle_ready(self, req, reader, writer):
        """Readiness: would a submission be admitted right now?  The
        reasons are :meth:`EnsembleServer.refusal_reasons`, the predicate
        ``submit`` enforces, plus the serving thread's liveness."""
        srv = self.server
        reasons = srv.refusal_reasons()
        if (self._serve_thread is not None
                and not self._serve_thread.is_alive()):
            reasons.append("serving_thread_dead")
        await _respond_json(
            writer, {"ready": not reasons, "reasons": reasons,
                     "queue_depth": len(srv.queue),
                     "queue_capacity": srv.queue.capacity},
            status=200 if not reasons else 503)

    async def _handle_stats(self, req, reader, writer):
        await _respond_json(writer, self.snapshot())

    async def _handle_metrics(self, req, reader, writer):
        """GET /v1/metrics: the Prometheus text exposition of the
        server's registry (snapshot on scrape)."""
        await _respond(writer, 200, self.metrics.render().encode("utf-8"),
                       _PROM_CONTENT_TYPE)

    async def _handle_profile(self, req, reader, writer):
        """POST /v1/profile ``{"action": "start"|"stop"}``: a
        ``torch.profiler`` capture (CPU and, on the GPU, CUDA activity)
        of whatever runs between the two calls, written as a Chrome
        trace under ``profile_dir``.  The masked segments carry the
        ``serve.segment`` region, the sink spans' name."""
        try:
            body = self._body_json(req)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            await _respond_json(writer, protocol.error_event(
                "bad_request", f"body is not JSON: {e}"), status=400)
            return
        action = body.get("action") if isinstance(body, dict) else None
        if action not in ("start", "stop"):
            await _respond_json(writer, protocol.error_event(
                "bad_request",
                f"action must be 'start' or 'stop', got {action!r}"),
                status=400)
            return
        if not self._profile_dir:
            await _respond_json(writer, protocol.error_event(
                "profiler_unavailable",
                "this gateway was started without profile_dir; "
                "restart with Gateway(profile_dir=...)"), status=501)
            return
        if self._serve_thread is None:
            # No serving loop to capture: the command runs here.
            status, payload = self._profile_action(action)
        elif not self._serve_thread.is_alive():
            status, payload = 501, protocol.error_event(
                "profiler_unavailable", "the serving loop has stopped")
        else:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            self._profile_cmds.put((action, fut))
            try:
                status, payload = await asyncio.wait_for(
                    asyncio.wrap_future(fut), timeout=120)
            except asyncio.TimeoutError:
                status, payload = 501, protocol.error_event(
                    "profiler_unavailable", "the serving loop did not "
                    "take the profiler command within 120 s")
        await _respond_json(writer, payload, status=status)

    def _run_profile_cmds(self) -> None:
        """Run the queued profiler commands on this (the serving)
        thread."""
        while True:
            try:
                action, fut = self._profile_cmds.get_nowait()
            except queue.Empty:
                return
            try:
                fut.set_result(self._profile_action(action))
            except Exception as e:
                fut.set_exception(e)

    def _drop_profiler(self) -> None:
        """Stop a capture left running by this thread (shutdown)."""
        if (self._profiler is not None
                and self._profiler_thread == threading.get_ident()):
            prof, self._profiler = self._profiler, None
            try:
                prof.stop()
            except RuntimeError as e:
                log.warning("gateway: profiler stop at shutdown failed "
                            "(%s)", e)

    def _profile_action(self, action: str) -> Tuple[int, dict]:
        """Start or stop the capture on the calling thread."""
        import torch

        if action == "start":
            if self._profiler is not None:
                return 409, protocol.error_event(
                    "profile_conflict",
                    "a profiler capture is already running; POST "
                    "{'action': 'stop'} first")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.server.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                os.makedirs(self._profile_dir, exist_ok=True)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            except (RuntimeError, OSError) as e:
                return 501, protocol.error_event(
                    "profiler_unavailable", str(e))
            self._profiler = prof
            self._profiler_thread = threading.get_ident()
            return 200, {"profiling": True, "dir": self._profile_dir}
        if self._profiler is None:
            return 409, protocol.error_event(
                "profile_conflict", "no profiler capture is running")
        prof, self._profiler = self._profiler, None
        self._profiles += 1
        path = os.path.join(self._profile_dir,
                            f"trace-{os.getpid()}-{self._profiles}.json")
        try:
            prof.stop()
            prof.export_chrome_trace(path)
        except (RuntimeError, OSError) as e:
            return 501, protocol.error_event(
                "profiler_unavailable", str(e))
        return 200, {"profiling": False, "dir": self._profile_dir,
                     "trace": path}

    def snapshot(self) -> dict:
        """The stats payload, also callable in-process (no HTTP)."""
        srv = self.server
        snap = {
            "gateway": dict(self.stats),
            "server": dict(srv.stats),
            "queue_depth": len(srv.queue),
            "queue_capacity": srv.queue.capacity,
            "draining": self.draining,
            "buckets": list(srv.buckets),
            "active_buckets": list(srv.active_buckets),
            "occupancy_mean": round(srv.occupancy_mean, 4),
            "utilization_mean": round(srv.utilization_mean, 4),
            "last_occupancy": srv.stats.get("last_occupancy", 0.0),
            "warm_compiles": self.warm_compiles,
            "compile_count": srv.compile_count(),
            "guard_events": (len(srv.monitor.events)
                             if srv.monitor is not None else 0),
        }
        placement = srv.placement_summary()
        if placement is not None:
            snap["placement"] = placement
        if self._autoscale is not None:
            snap["autoscale"] = self._autoscale.summary()
        snap["bucket_costs"] = srv.bucket_costs()
        memory = srv.memory_snapshot()
        if memory is not None:
            snap["memory"] = memory
        # The warm pool's counters, probe verdicts and speculative builds,
        # only where a pool is configured (a pool-less deployment's
        # payload is unchanged).
        warm = srv.warmpool_summary()
        if warm is not None:
            snap["warm_pool"] = warm
        return snap
