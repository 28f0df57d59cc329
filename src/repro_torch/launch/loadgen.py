"""Streaming HTTP clients + concurrent load harness for the front door.

Stdlib-only counterpart of :mod:`repro_torch.launch.server`: raw
``asyncio.open_connection`` HTTP/1.1 with chunked-transfer SSE decoding,
so tests, benchmarks, and the CI server leg can drive the server without
an HTTP client dependency.

``make_prompts`` reproduces the synthetic workload recipe of
``launch/serve.py`` (same rng seed -> same prompts), which is what lets
the CI matrix compare the server's streamed tokens against the
direct-engine legs token for token.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

import numpy as np

from .engine import _percentile
from .faults import get_injector


def make_prompts(n: int, prompt_len: int, vocab: int,
                 seed: int = 0) -> List[np.ndarray]:
    """The serve.py workload recipe: prompts drawn sequentially from one
    ``default_rng(seed)`` stream — prompt ``i`` here is the prompt the
    CLI would submit as request ``i``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(prompt_len,)).astype(np.int32)
            for _ in range(n)]


def _split(base_url: str) -> Tuple[str, int]:
    u = urllib.parse.urlparse(base_url)
    if u.scheme != "http" or u.hostname is None or u.port is None:
        raise ValueError(f"need an http://host:port base url, "
                         f"got {base_url!r}")
    return u.hostname, u.port


async def _read_head(reader: asyncio.StreamReader) -> Tuple[int, Dict[str, str]]:
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return status, headers


async def _read_body(reader: asyncio.StreamReader,
                     headers: Dict[str, str]) -> bytes:
    n = int(headers.get("content-length", 0) or 0)
    return await reader.readexactly(n) if n else b""


async def http_json(base_url: str, method: str, path: str,
                    doc: Optional[dict] = None,
                    timeout: float = 60.0) -> Tuple[int, dict]:
    """One non-streaming JSON request; returns (status, parsed body)."""
    host, port = _split(base_url)
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(doc).encode() if doc is not None else b""
        req = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
        writer.write(req.encode() + body)
        await writer.drain()
        status, headers = await asyncio.wait_for(_read_head(reader), timeout)
        raw = await asyncio.wait_for(_read_body(reader, headers), timeout)
        return status, (json.loads(raw) if raw else {})
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


def fetch_json(base_url: str, path: str, timeout: float = 60.0) -> dict:
    """Sync convenience for metrics/health polls from non-async code."""
    status, doc = asyncio.run(http_json(base_url, "GET", path,
                                        timeout=timeout))
    if status != 200:
        raise RuntimeError(f"GET {path} -> {status}: {doc}")
    return doc


def wait_ready(base_url: str, timeout: float = 180.0) -> None:
    """Poll ``/healthz`` until the server answers (subprocess startup)."""
    deadline = time.monotonic() + timeout
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            if fetch_json(base_url, "/healthz", timeout=5).get("ok"):
                return
        except Exception as exc:  # noqa: BLE001 — connection refused etc.
            last = exc
        time.sleep(0.2)
    raise TimeoutError(f"server at {base_url} not ready in {timeout}s "
                       f"(last error: {last})")


@dataclasses.dataclass
class StreamResult:
    """One streamed generate call, as the client observed it."""

    status: int
    tokens: List[int]
    ttft_ms: Optional[float]     # request write -> first token event
    gaps_ms: List[float]         # inter-token event spacing
    error: Optional[str] = None
    terminal: str = "completed"  # request's terminal status (done event)
    disconnected: bool = False   # we hung up early (disconnect_after)


async def stream_generate(base_url: str, payload: dict,
                          timeout: float = 600.0,
                          disconnect_after: Optional[int] = None
                          ) -> StreamResult:
    """POST /v1/generate and consume the SSE stream to completion.

    ``disconnect_after=n`` hangs up (closes the socket mid-stream) after
    the n-th token event — the misbehaving-client harness: the server is
    expected to cancel the request so it stops holding slot/pages."""
    host, port = _split(base_url)
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(payload).encode()
        req = (f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
        t0 = time.perf_counter()
        writer.write(req.encode() + body)
        await writer.drain()
        status, headers = await asyncio.wait_for(_read_head(reader), timeout)
        if status != 200:
            raw = await asyncio.wait_for(_read_body(reader, headers),
                                         timeout)
            doc = json.loads(raw) if raw else {}
            return StreamResult(status, [], None, [],
                                error=doc.get("error", f"HTTP {status}"))
        if headers.get("transfer-encoding") != "chunked":
            return StreamResult(status, [], None, [],
                                error="response is not chunked")
        tokens: List[int] = []
        gaps: List[float] = []
        ttft = None
        t_last = None
        final: Optional[List[int]] = None
        error = None
        terminal = "completed"
        disconnected = False
        buf = b""
        while not disconnected:
            line = await asyncio.wait_for(reader.readline(), timeout)
            size = int(line.strip() or b"0", 16)
            if size == 0:
                break
            buf += await reader.readexactly(size)
            await reader.readexactly(2)  # chunk CRLF
            # SSE events may span chunk boundaries; split on the blank
            # line and keep the unterminated tail buffered (bare
            # ": heartbeat" comment events carry no data: line)
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                for ln in event.decode().splitlines():
                    if not ln.startswith("data:"):
                        continue
                    ev = json.loads(ln[5:].strip())
                    now = time.perf_counter()
                    if "token" in ev:
                        if ttft is None:
                            ttft = (now - t0) * 1e3
                        elif t_last is not None:
                            gaps.append((now - t_last) * 1e3)
                        t_last = now
                        tokens.append(int(ev["token"]))
                        if disconnect_after is not None \
                                and len(tokens) >= disconnect_after:
                            disconnected = True
                    elif ev.get("done"):
                        final = [int(t) for t in ev["tokens"]]
                        terminal = str(ev.get("status", "completed"))
                        if "error" in ev:
                            error = str(ev["error"])
                    elif "error" in ev:
                        error = str(ev["error"])
                if disconnected:
                    break
        if not disconnected and final is not None and final != tokens:
            error = error or (f"final token list disagrees with the "
                              f"stream ({len(final)} vs {len(tokens)})")
        return StreamResult(status, final if final is not None else tokens,
                            ttft, gaps, error=error, terminal=terminal,
                            disconnected=disconnected)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


@dataclasses.dataclass
class LoadResult:
    """Aggregate of one concurrent-client load run."""

    results: Dict[str, List[int]]   # tag -> streamed tokens
    statuses: Dict[int, int]        # HTTP status -> count
    errors: List[str]
    wall_s: float
    total_tokens: int
    ttft_p50_ms: float
    ttft_p95_ms: float
    gap_p50_ms: float
    gap_p95_ms: float
    terminals: Dict[str, int] = dataclasses.field(default_factory=dict)
    disconnects: int = 0

    @property
    def tok_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)


async def run_load_async(base_url: str, prompts: List, gen: int, *,
                         temperature: float = 0.0, top_k: int = 0,
                         concurrency: Optional[int] = None,
                         timeout: float = 600.0,
                         disconnect_after: Optional[int] = None,
                         request_timeout: Optional[float] = None
                         ) -> LoadResult:
    """Fire one streaming client per prompt (client ``i`` tagged ``i``),
    all concurrent (bounded by ``concurrency`` when given).

    ``disconnect_after`` makes every client hang up after that many
    tokens; the ``client.disconnect_after_n`` fault site does the same
    selectively (its rule picks which clients, its payload says after
    how many tokens).  Disconnected clients are excluded from the
    parity ``results`` map — their streams are intentionally partial."""
    sem = asyncio.Semaphore(concurrency) if concurrency else None
    inj = get_injector()

    async def one(i: int, prompt) -> StreamResult:
        payload = {"prompt": [int(t) for t in prompt], "max_new": int(gen),
                   "tag": i}
        if temperature or top_k:
            payload.update(temperature=temperature, top_k=top_k, key=i)
        if request_timeout is not None:
            payload["timeout"] = request_timeout
        da = disconnect_after
        if da is None and inj.fire("client.disconnect_after_n"):
            da = max(int(inj.value("client.disconnect_after_n", 1)), 1)
        if sem is None:
            return await stream_generate(base_url, payload, timeout,
                                         disconnect_after=da)
        async with sem:
            return await stream_generate(base_url, payload, timeout,
                                         disconnect_after=da)

    t0 = time.perf_counter()
    outs = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    wall = time.perf_counter() - t0
    results: Dict[str, List[int]] = {}
    statuses: Dict[int, int] = {}
    errors: List[str] = []
    ttft: List[float] = []
    gaps: List[float] = []
    terminals: Dict[str, int] = {}
    disconnects = 0
    for i, r in enumerate(outs):
        statuses[r.status] = statuses.get(r.status, 0) + 1
        if r.status == 200:
            terminals[r.terminal] = terminals.get(r.terminal, 0) + 1
        if r.disconnected:
            disconnects += 1
        elif r.error:
            errors.append(f"client {i}: {r.error}")
        if r.status == 200 and not r.error and not r.disconnected \
                and r.terminal == "completed":
            results[str(i)] = r.tokens
        if r.ttft_ms is not None:
            ttft.append(r.ttft_ms)
        gaps.extend(r.gaps_ms)
    return LoadResult(
        results=results, statuses=statuses, errors=errors, wall_s=wall,
        total_tokens=sum(len(v) for v in results.values()),
        ttft_p50_ms=_percentile(ttft, 50), ttft_p95_ms=_percentile(ttft, 95),
        gap_p50_ms=_percentile(gaps, 50), gap_p95_ms=_percentile(gaps, 95),
        terminals=terminals, disconnects=disconnects)


def run_load(base_url: str, prompts: List, gen: int, **kw) -> LoadResult:
    return asyncio.run(run_load_async(base_url, prompts, gen, **kw))
