"""Asyncio HTTP front door over :class:`repro_torch.launch.engine.ServeEngine`.

The engine owns compilation, KV memory, and the decode hot loop; this
module gives it a network edge — stdlib only (``asyncio`` +
hand-framed HTTP/1.1), so serving needs nothing the compiler stack
doesn't already ship.  One :class:`ServeHTTPServer` owns one engine on a
dedicated *engine thread* (the engine is single-threaded by design: all
``submit``/``step`` calls happen there) and bridges it to any number of
concurrent clients:

  * ``POST /v1/generate`` — JSON body with ``prompt`` (token ids) or
    ``text`` (bytes folded into the vocabulary), ``max_new``, and the
    paged-mode sampling knobs (``temperature``/``top_k``/``key``).  The
    response streams Server-Sent Events over chunked transfer encoding:
    one ``{"token": t}`` event per generated token, then a final
    ``{"done": true, "tokens": [...]}`` event carrying the whole
    continuation.
  * ``GET /v1/metrics`` — rolling server SLOs (TTFT p50/p95, inter-token
    p50/p95, sustained tok/s) from :class:`ServerStats` plus the
    engine's instantaneous gauges (queue depth, active slots,
    pages_in_use) from ``ServeEngine.live_stats()``.
  * ``GET /healthz`` — liveness + drain state.

Admission maps onto the engine's queue-aware ``can_admit``: a request
that would have to wait joins a *bounded* wait queue; when the queue is
full the server answers 429 (back off and retry), and once draining has
begun every new generate gets 503.  Draining (SIGTERM on the CLI path,
:meth:`ServeHTTPServer.drain` programmatically) stops admissions,
finishes every accepted request, flushes all open streams, and verifies
the pool came back empty (``pages_in_use == 0``) — the clean-shutdown
contract the CI serving matrix gates on.

Token flow is thread-safe by construction: the engine thread is the only
engine caller; each client connection owns an ``asyncio.Queue`` that the
engine thread feeds through ``loop.call_soon_threadsafe``, so tokens
cross the thread boundary exactly once, already fanned out per request.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import threading
import time
from typing import Deque, Dict, List, Optional

import numpy as np

from .engine import ServeEngine, _percentile

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable"}


class ServerStats:
    """Rolling serving SLOs, fed from the engine thread, read anywhere.

    Keeps bounded sample windows (the newest ``window`` requests/tokens)
    so a long-lived server reports *current* behaviour, not its lifetime
    average; sustained throughput counts token arrivals over the last
    ``horizon`` seconds."""

    def __init__(self, window: int = 1024, horizon: float = 30.0):
        self._lock = threading.Lock()
        self._ttft_ms: Deque[float] = collections.deque(maxlen=window)
        self._gap_ms: Deque[float] = collections.deque(maxlen=window * 8)
        self._arrivals: Deque[float] = collections.deque(maxlen=window * 8)
        self.horizon = float(horizon)
        self.accepted = 0
        self.completed = 0
        self.rejected_429 = 0
        self.rejected_503 = 0
        self.rejected_413 = 0
        self.tokens_streamed = 0
        self.client_disconnects = 0
        self.forced_closes = 0

    def on_accept(self) -> None:
        with self._lock:
            self.accepted += 1

    def on_reject(self, status: int) -> None:
        with self._lock:
            if status == 429:
                self.rejected_429 += 1
            elif status == 413:
                self.rejected_413 += 1
            else:
                self.rejected_503 += 1

    def on_client_disconnect(self) -> None:
        with self._lock:
            self.client_disconnects += 1

    def on_forced_close(self, n: int = 1) -> None:
        with self._lock:
            self.forced_closes += int(n)

    def on_token(self, gap_ms: Optional[float], first: bool,
                 ttft_ms: Optional[float] = None) -> None:
        now = time.perf_counter()
        with self._lock:
            self.tokens_streamed += 1
            self._arrivals.append(now)
            if first and ttft_ms is not None:
                self._ttft_ms.append(ttft_ms)
            elif gap_ms is not None:
                self._gap_ms.append(gap_ms)

    def on_complete(self) -> None:
        with self._lock:
            self.completed += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            now = time.perf_counter()
            cut = now - self.horizon
            while self._arrivals and self._arrivals[0] < cut:
                self._arrivals.popleft()
            span = (now - self._arrivals[0]) if len(self._arrivals) >= 2 \
                else 0.0
            return {
                "requests_accepted": self.accepted,
                "requests_completed": self.completed,
                "rejected_429": self.rejected_429,
                "rejected_503": self.rejected_503,
                "rejected_413": self.rejected_413,
                "tokens_streamed": self.tokens_streamed,
                "client_disconnects": self.client_disconnects,
                "forced_closes": self.forced_closes,
                "ttft_p50_ms": _percentile(list(self._ttft_ms), 50),
                "ttft_p95_ms": _percentile(list(self._ttft_ms), 95),
                "tok_p50_ms": _percentile(list(self._gap_ms), 50),
                "tok_p95_ms": _percentile(list(self._gap_ms), 95),
                "sustained_tok_s": (len(self._arrivals) / span
                                    if span > 0 else 0.0),
            }


@dataclasses.dataclass
class _Stream:
    """One accepted generate request, bridging engine thread -> client."""

    prompt: np.ndarray
    max_new: int
    temperature: float
    top_k: int
    key: int
    tag: Optional[str]
    queue: "asyncio.Queue"
    loop: "asyncio.AbstractEventLoop"
    t_accept: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_last: Optional[float] = None
    deadline_s: Optional[float] = None  # client 'timeout' knob (seconds)
    rid: Optional[int] = None           # set by the engine thread at submit
    cancelled: bool = False             # client gone; cancel at/after submit


class ServeHTTPServer:
    """One engine, one engine thread, many streaming HTTP clients.

    ``port=0`` binds an ephemeral port (read :attr:`port` after
    :meth:`start`).  ``max_wait_queue`` bounds accepted-but-unadmitted
    requests: a generate that cannot be admitted immediately
    (queue-aware ``ServeEngine.can_admit``) joins the wait queue if
    there is room, else is bounced with 429."""

    def __init__(self, engine: ServeEngine, *, host: str = "127.0.0.1",
                 port: int = 0, max_wait_queue: int = 8,
                 max_body_bytes: int = 1 << 20, heartbeat_s: float = 10.0):
        if engine.mode not in ("continuous", "paged"):
            raise ValueError(
                f"the HTTP server needs a step()-capable engine "
                f"(continuous/paged), got mode={engine.mode!r}")
        if max_wait_queue < 0:
            raise ValueError(
                f"max_wait_queue must be >= 0, got {max_wait_queue}")
        if max_body_bytes < 1:
            raise ValueError(
                f"max_body_bytes must be >= 1, got {max_body_bytes}")
        if not heartbeat_s > 0:
            raise ValueError(f"heartbeat_s must be > 0, got {heartbeat_s}")
        self.engine = engine
        self.host = host
        self.port = int(port)
        self.max_wait_queue = int(max_wait_queue)
        self.max_body_bytes = int(max_body_bytes)
        self.heartbeat_s = float(heartbeat_s)
        self.stats = ServerStats()

        # engine-thread state: _cv guards _pending/_cancels/_draining;
        # _live is touched only by the engine thread after submission
        self._cv = threading.Condition()
        self._pending: Deque[_Stream] = collections.deque()
        self._cancels: Deque[int] = collections.deque()
        self._draining = False
        self._live: Dict[int, _Stream] = {}
        self._results: Dict[str, List[int]] = {}
        self._engine_error: Optional[BaseException] = None
        self._engine_thread: Optional[threading.Thread] = None

        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown: Optional[asyncio.Event] = None
        self._thread: Optional[threading.Thread] = None

        self.engine_report = None
        self.drain_ok: Optional[bool] = None

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._shutdown = asyncio.Event()
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="serve-engine", daemon=True)
        self._engine_thread.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def drain(self) -> None:
        """Graceful shutdown: stop admitting, finish every accepted
        request, flush all open streams, then verify the pool drained."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        if self._engine_thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._engine_thread.join)
        if self._server is not None:
            self._server.close()
        # every stream already holds its terminal event; wait for the
        # connection handlers to flush it down the wire — and force-close
        # whatever survives the timeout instead of abandoning it silently
        # (an abandoned handler would hold its socket open forever and
        # the drain would still have claimed success)
        conns = [t for t in self._conns if not t.done()]
        if conns:
            _, alive = await asyncio.wait(conns, timeout=30)
            if alive:
                for t in alive:
                    t.cancel()
                await asyncio.gather(*alive, return_exceptions=True)
                self.stats.on_forced_close(len(alive))
                self.drain_ok = False
        if self._server is not None:
            await self._server.wait_closed()

    async def run_async(self, *, signals: bool = False,
                        on_ready=None) -> None:
        """Start, then serve until :meth:`shutdown` (or SIGTERM/SIGINT
        when ``signals``), then drain."""
        await self.start()
        if signals:
            import signal as _signal
            loop = asyncio.get_running_loop()
            for sig in (_signal.SIGTERM, _signal.SIGINT):
                loop.add_signal_handler(sig, self._shutdown.set)
        if on_ready is not None:
            on_ready()
        await self._shutdown.wait()
        await self.drain()

    def serve_forever(self, on_ready=None) -> None:
        """Blocking CLI entry: serve until SIGTERM/SIGINT, then drain."""
        asyncio.run(self.run_async(signals=True, on_ready=on_ready))

    # threaded runner (tests / benchmarks / in-process load harnesses)
    def start_in_thread(self) -> "ServeHTTPServer":
        ready = threading.Event()
        self._thread = threading.Thread(
            target=lambda: asyncio.run(
                self.run_async(on_ready=ready.set)),
            name="serve-http", daemon=True)
        self._thread.start()
        if not ready.wait(timeout=120):
            raise RuntimeError("HTTP server failed to start")
        return self

    def shutdown(self, timeout: float = 120.0) -> None:
        """Thread-safe: trigger drain and wait for the server thread."""
        if self._loop is None or self._shutdown is None:
            return
        self._loop.call_soon_threadsafe(self._shutdown.set)
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("HTTP server did not drain in time")

    # -- the engine thread ---------------------------------------------------
    def _engine_busy(self) -> bool:
        return self.engine.queue_depth > 0 or (
            self.engine.pool is not None and self.engine.pool.active > 0)

    def _engine_loop(self) -> None:
        eng = self.engine
        try:
            while True:
                with self._cv:
                    while not self._pending and not self._cancels \
                            and not self._engine_busy() \
                            and not self._draining:
                        self._cv.wait()
                    if self._draining and not self._pending \
                            and not self._cancels \
                            and not self._engine_busy():
                        break
                    batch = list(self._pending)
                    self._pending.clear()
                    cancels = list(self._cancels)
                    self._cancels.clear()
                for rid in cancels:
                    eng.cancel(rid, "client disconnected")
                for item in batch:
                    deadline = item.deadline_s
                    if deadline is not None:
                        # the knob bounds the whole request, so charge
                        # the time it already waited for this thread
                        deadline = max(
                            deadline - (time.perf_counter() - item.t_accept),
                            1e-3)
                    rid = eng.submit(item.prompt, item.max_new,
                                     temperature=item.temperature,
                                     top_k=item.top_k, key=item.key,
                                     deadline_s=deadline)
                    item.rid = rid
                    self._live[rid] = item
                    if item.cancelled:  # client left before submission
                        eng.cancel(rid, "client disconnected")
                if self._engine_busy():
                    for rid, tok in eng.step():
                        self._emit(rid, tok)
                for rid, status, error in eng.drain_events():
                    self._on_terminal(rid, status, error)
        except BaseException as exc:  # fail loudly into every open stream
            self._engine_error = exc
            with self._cv:
                stranded = list(self._pending)
                self._pending.clear()
            for item in stranded + list(self._live.values()):
                self._push(item, ("err", f"{type(exc).__name__}: {exc}"))
            self._live.clear()
        finally:
            self._finalize()

    def _emit(self, rid: int, tok: int) -> None:
        item = self._live.get(rid)
        if item is None:
            return
        now = time.perf_counter()
        first = not item.tokens
        self.stats.on_token(
            gap_ms=None if first or item.t_last is None
            else (now - item.t_last) * 1e3,
            first=first,
            ttft_ms=(now - item.t_accept) * 1e3 if first else None)
        item.t_last = now
        item.tokens.append(int(tok))
        self._push(item, ("tok", int(tok)))

    def _on_terminal(self, rid: int, status: str,
                     error: Optional[str]) -> None:
        """A drained engine terminal event: close out the stream with the
        request's terminal status (``completed`` keeps the legacy
        ``done`` event; everything else ends with status + error)."""
        item = self._live.pop(rid, None)
        if item is None:
            return
        if status == "completed":
            key = item.tag if item.tag is not None else str(rid)
            self._results[key] = list(item.tokens)
            # counted before the client can see its done event, so a
            # metrics read after a finished stream includes it
            self.stats.on_complete()
            self._push(item, ("done", list(item.tokens)))
        else:
            self._push(item, ("end", {"status": status, "error": error,
                                      "tokens": list(item.tokens)}))

    def _request_cancel(self, item: _Stream) -> None:
        """Asyncio side: the client went away (or errored) mid-stream —
        route a cancel to the engine thread so the request stops holding
        slot/pages.  Safe against the accept->submit race: ``cancelled``
        is set before reading ``rid``, and the engine thread assigns
        ``rid`` before checking ``cancelled``."""
        with self._cv:
            item.cancelled = True
            if item in self._pending:    # never reached the engine
                self._pending.remove(item)
                return
            if item.rid is not None:
                self._cancels.append(item.rid)
                self._cv.notify_all()

    def _push(self, item: _Stream, msg) -> None:
        try:
            item.loop.call_soon_threadsafe(item.queue.put_nowait, msg)
        except RuntimeError:
            pass  # client's loop is gone; the engine finishes regardless

    def _finalize(self) -> None:
        eng = self.engine
        pool = eng.pool
        self.drain_ok = (self._engine_error is None
                         and eng.queue_depth == 0
                         and (pool is None or pool.active == 0)
                         and getattr(pool, "pages_in_use", 0) == 0)
        if self._engine_error is None:
            try:
                self.engine_report = eng.run()  # drained: report only
            except Exception as exc:
                self._engine_error = exc
                self.drain_ok = False

    # -- report (CI serving matrix / benchmarks) -----------------------------
    def report_doc(self) -> Dict:
        """Post-drain report in the serving-matrix artifact shape:
        results keyed by the client-supplied ``tag`` (falling back to the
        engine rid) so concurrent arrival order can't scramble parity
        comparisons against the direct-engine legs."""
        rep = self.engine_report
        doc = dataclasses.asdict(rep) if rep is not None else {}
        doc["mode"] = "server"
        doc["engine_mode"] = self.engine.mode
        doc["results"] = {k: [int(t) for t in v]
                          for k, v in self._results.items()}
        doc["server"] = self.stats.snapshot()
        doc["drain_ok"] = bool(self.drain_ok)
        doc["health"] = self.engine.health
        if self._engine_error is not None:
            doc["engine_error"] = str(self._engine_error)
        return doc

    # -- HTTP plumbing -------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), timeout=30)
            except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                    asyncio.LimitOverrunError):
                return
            lines = head.decode("latin1").split("\r\n")
            parts = lines[0].split(" ")
            if len(parts) < 3:
                writer.write(self._resp(400, {"error": "bad request line"}))
                return
            method, target = parts[0].upper(), parts[1].split("?", 1)[0]
            headers = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, v = ln.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            n = int(headers.get("content-length", 0) or 0)
            if n > self.max_body_bytes:
                # drain the oversized body in bounded chunks first, so
                # the rejection isn't clobbered by a TCP reset from
                # closing a socket with unread data
                left = n
                while left > 0:
                    chunk = await reader.read(min(left, 1 << 16))
                    if not chunk:
                        break
                    left -= len(chunk)
                self.stats.on_reject(413)
                writer.write(self._resp(413, {
                    "error": f"body of {n} bytes exceeds "
                             f"max_body_bytes={self.max_body_bytes}"}))
                await writer.drain()
                return
            body = await reader.readexactly(n) if n else b""
            await self._route(method, target, body, writer)
        except OSError:
            pass  # client went away mid-stream; nothing to flush
        finally:
            self._conns.discard(task)
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        if path == "/healthz" and method == "GET":
            health = self.engine.health
            writer.write(self._resp(200, {"ok": health != "halted",
                                          "health": health,
                                          "draining": self._draining}))
        elif path == "/v1/metrics" and method == "GET":
            doc = {
                "server": self.stats.snapshot(),
                "engine": self.engine.live_stats(),
                "health": self.engine.health,
                "wait_queue": len(self._pending) + self.engine.queue_depth,
                "max_wait_queue": self.max_wait_queue,
                "draining": self._draining,
            }
            writer.write(self._resp(200, doc))
        elif path == "/v1/generate" and method == "POST":
            await self._generate(body, writer)
        elif path in ("/healthz", "/v1/metrics", "/v1/generate"):
            writer.write(self._resp(405, {"error": f"{method} not allowed"}))
        else:
            writer.write(self._resp(404, {"error": f"no route {path}"}))
        await writer.drain()

    def _parse_generate(self, body: bytes) -> _Stream:
        """Request body -> a validated ``_Stream`` (ValueError = 400)."""
        try:
            doc = json.loads(body or b"{}")
        except json.JSONDecodeError as exc:
            raise ValueError(f"body is not valid JSON: {exc}")
        if not isinstance(doc, dict):
            raise ValueError("body must be a JSON object")
        vocab = self.engine.cfg.vocab
        prompt = doc.get("prompt")
        if prompt is None and "text" in doc:
            if not isinstance(doc["text"], str):
                raise ValueError("'text' must be a string")
            # bytes folded into the vocabulary: a stand-in tokenizer so
            # text clients work against the synthetic-weight model
            prompt = [b % vocab for b in doc["text"].encode("utf-8")]
        if not isinstance(prompt, list) or not prompt:
            raise ValueError("'prompt' must be a non-empty list of "
                             "token ids (or provide 'text')")
        try:
            ids = [int(t) for t in prompt]
        except (TypeError, ValueError):
            raise ValueError("'prompt' must contain integers")
        if any(not 0 <= t < vocab for t in ids):
            raise ValueError(f"prompt ids must be in [0, {vocab})")
        try:
            max_new = int(doc.get("max_new", 16))
            temperature = float(doc.get("temperature", 0.0))
            top_k = int(doc.get("top_k", 0))
            key = int(doc.get("key", 0))
        except (TypeError, ValueError):
            raise ValueError("max_new/top_k/key must be integers, "
                             "temperature a number")
        tag = doc.get("tag")
        if tag is not None and not isinstance(tag, (str, int)):
            raise ValueError("'tag' must be a string or integer")
        timeout = doc.get("timeout")
        if timeout is not None:
            try:
                timeout = float(timeout)
            except (TypeError, ValueError):
                raise ValueError("'timeout' must be a number of seconds")
        # full engine validation (max_len, page budget, sampling/mode,
        # deadline) — the 'timeout' knob maps to the engine deadline
        self.engine.check_request(len(ids), max_new,
                                  temperature=temperature, top_k=top_k,
                                  key=key, deadline_s=timeout)
        return _Stream(
            prompt=np.asarray(ids, np.int32), max_new=max_new,
            temperature=temperature, top_k=top_k, key=key,
            tag=str(tag) if tag is not None else None,
            queue=asyncio.Queue(), loop=asyncio.get_running_loop(),
            t_accept=time.perf_counter(), deadline_s=timeout)

    async def _generate(self, body: bytes,
                        writer: asyncio.StreamWriter) -> None:
        try:
            item = self._parse_generate(body)
        except ValueError as exc:
            writer.write(self._resp(400, {"error": str(exc)}))
            return
        with self._cv:
            if self._draining:
                self.stats.on_reject(503)
                writer.write(self._resp(
                    503, {"error": "server is draining"}))
                return
            depth = len(self._pending) + self.engine.queue_depth
            if not self.engine.can_admit(len(item.prompt), item.max_new,
                                         prompt=item.prompt) \
                    and depth >= self.max_wait_queue:
                self.stats.on_reject(429)
                writer.write(self._resp(
                    429, {"error": f"wait queue full ({depth} waiting)"},
                    extra=("Retry-After: 1",)))
                return
            self._pending.append(item)
            self._cv.notify_all()
        self.stats.on_accept()

        try:
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-store\r\n"
                b"Transfer-Encoding: chunked\r\n"
                b"Connection: close\r\n\r\n")
            await writer.drain()
            while True:
                try:
                    kind, payload = await asyncio.wait_for(
                        item.queue.get(), timeout=self.heartbeat_s)
                except asyncio.TimeoutError:
                    # SSE comment: clients can tell a slow token from a
                    # hung engine, and a dead socket surfaces here as a
                    # write failure instead of lingering forever
                    hb = b": heartbeat\n\n"
                    writer.write(b"%x\r\n" % len(hb) + hb + b"\r\n")
                    await writer.drain()
                    continue
                if kind == "tok":
                    ev = {"token": payload}
                elif kind == "done":
                    ev = {"done": True, "status": "completed",
                          "tokens": payload}
                elif kind == "end":  # cancelled/deadline_exceeded/failed
                    ev = {"done": True, "status": payload["status"],
                          "error": payload["error"],
                          "tokens": payload["tokens"]}
                else:
                    ev = {"error": payload}
                data = f"data: {json.dumps(ev)}\n\n".encode()
                writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
                await writer.drain()
                if kind == "tok":
                    continue
                break
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError,
                asyncio.CancelledError):
            # the client went away mid-stream (or drain force-closed us):
            # stop the request so it releases its slot and pages
            self.stats.on_client_disconnect()
            self._request_cancel(item)
            raise

    @staticmethod
    def _resp(status: int, doc: Dict, ctype: str = "application/json",
              extra=()) -> bytes:
        body = (json.dumps(doc) + "\n").encode()
        head = [f"HTTP/1.1 {status} {_REASONS[status]}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}",
                "Connection: close", *extra]
        return ("\r\n".join(head) + "\r\n\r\n").encode() + body


@contextlib.contextmanager
def running_server(engine: ServeEngine, **kw):
    """``with running_server(engine) as srv:`` — threaded server for
    tests and in-process load harnesses; drains on exit."""
    srv = ServeHTTPServer(engine, **kw)
    srv.start_in_thread()
    try:
        yield srv
    finally:
        srv.shutdown()
