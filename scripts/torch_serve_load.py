"""Concurrent-client load driver + backpressure probe for the torch port's
front door (the port of ``scripts/serve_load.py``; imports only
``repro_torch``).

``python scripts/torch_serve_load.py --base-url http://127.0.0.1:8777 \
    --reduced --requests 3 --prompt-len 4 --gen 6``
drives N tagged concurrent streaming clients against an already-running
``python -m repro_torch.launch.serve --serve-http`` process, using the
CLI's synthetic-workload recipe (``loadgen.make_prompts`` with the same
seed), so the tokens the server streams here are the tokens the CLI's
local run decodes for the same flags.  Exit code 1 if any client fails,
errors mid-stream, or gets anything but 200.

``python scripts/torch_serve_load.py --probe-backpressure --reduced``
builds its own in-process server on ``--device`` (the card by default;
``--device cpu`` runs it on the CPU), sized to make every rejection
deterministic (1 slot, wait queue 0), and walks the admission contract:

  1. client A streams a long generation and occupies the only slot;
  2. client B arrives while A is active -> 429 (wait queue full);
  3. drain begins (programmatic shutdown) while A is still streaming;
  4. client C arrives during the drain -> 503 (draining);
  5. A still finishes with every token, and the drain leaves
     ``pages_in_use == 0``.

Any deviation is an assertion with the observed state in the message.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def _config(args):
    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def run_clients(args) -> int:
    from repro_torch.launch import loadgen

    cfg = _config(args)
    loadgen.wait_ready(args.base_url, timeout=args.ready_timeout)
    prompts = loadgen.make_prompts(args.requests, args.prompt_len,
                                   cfg.vocab, seed=args.seed)
    res = loadgen.run_load(args.base_url, prompts, args.gen,
                           temperature=args.temperature, top_k=args.top_k,
                           timeout=args.timeout)
    print(f"[serve-load] {args.requests} clients x {args.gen} tokens: "
          f"statuses={res.statuses} {res.total_tokens} tokens in "
          f"{res.wall_s:.2f}s ({res.tok_s:.1f} tok/s), "
          f"ttft p50 {res.ttft_p50_ms:.1f}ms p95 {res.ttft_p95_ms:.1f}ms, "
          f"gap p50 {res.gap_p50_ms:.2f}ms p95 {res.gap_p95_ms:.2f}ms")
    failures = list(res.errors)
    if res.statuses != {200: args.requests}:
        failures.append(f"expected {args.requests} x HTTP 200, "
                        f"got {res.statuses}")
    short = [t for t, toks in sorted(res.results.items())
             if len(toks) != args.gen]
    if short:
        failures.append(f"clients {short} streamed fewer than "
                        f"{args.gen} tokens")
    if failures:
        for f in failures:
            print(f"LOAD FAIL: {f}", file=sys.stderr)
        return 1
    metrics = loadgen.fetch_json(args.base_url, "/v1/metrics")
    srv = metrics.get("server", {})
    print(f"[serve-load] server metrics: "
          f"completed={srv.get('requests_completed')} "
          f"ttft_p95={srv.get('ttft_p95_ms', 0):.1f}ms "
          f"sustained={srv.get('sustained_tok_s', 0):.1f} tok/s")
    return 0


def probe_backpressure(args) -> int:
    from repro_torch.launch import loadgen
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    from repro_torch.launch.server import ServeHTTPServer

    cfg = _config(args)
    P, G = args.prompt_len, max(args.gen, 64)  # A must outlive the probe
    eng = ServeEngine(cfg, EngineConfig(mode="paged", slots=1,
                                        max_len=P + G, seed=args.seed,
                                        page_size=4, chunk_steps=1,
                                        device=args.device))
    srv = ServeHTTPServer(eng, max_wait_queue=0)
    srv.start_in_thread()
    url = srv.base_url
    prompt = [int(t) for t in
              loadgen.make_prompts(1, P, cfg.vocab, seed=args.seed)[0]]

    # 1. A takes the only slot and keeps streaming
    a_box = {}

    def _client_a():
        a_box["res"] = asyncio.run(loadgen.stream_generate(
            url, {"prompt": prompt, "max_new": G, "tag": "A"},
            timeout=args.timeout))

    a_thread = threading.Thread(target=_client_a, daemon=True)
    a_thread.start()
    _poll(lambda: loadgen.fetch_json(url, "/v1/metrics")
          ["engine"]["active_slots"] >= 1,
          "client A never occupied the slot")

    # 2. B while A is active: the wait queue is 0-deep -> 429
    rb = asyncio.run(loadgen.stream_generate(
        url, {"prompt": prompt, "max_new": G, "tag": "B"}, timeout=30))
    assert rb.status == 429, \
        f"expected 429 while the slot is held, got {rb.status} ({rb.error})"

    # 3. drain while A is still streaming
    stopper = threading.Thread(target=srv.shutdown, daemon=True)
    stopper.start()
    _poll(lambda: loadgen.fetch_json(url, "/healthz")["draining"],
          "server never reported draining")

    # 4. C during the drain -> 503
    rc = asyncio.run(loadgen.stream_generate(
        url, {"prompt": prompt, "max_new": G, "tag": "C"}, timeout=30))
    assert rc.status == 503, \
        f"expected 503 during drain, got {rc.status} ({rc.error})"

    # 5. A finishes intact, drain returns every page
    a_thread.join(args.timeout)
    assert not a_thread.is_alive(), "client A never completed"
    ra = a_box["res"]
    assert ra.status == 200 and not ra.error and len(ra.tokens) == G, \
        f"client A must finish through the drain: status={ra.status} " \
        f"tokens={len(ra.tokens)}/{G} error={ra.error}"
    stopper.join(120)
    assert not stopper.is_alive(), "shutdown did not complete"
    assert srv.drain_ok, "drain left engine state behind"
    assert eng.pool.pages_in_use == 0, \
        f"{eng.pool.pages_in_use} pages still in use after the drain"
    snap = srv.stats.snapshot()
    assert snap["rejected_429"] == 1 and snap["rejected_503"] == 1, \
        f"expected exactly one 429 and one 503, got {snap}"
    print(f"[probe-backpressure] ok on {eng.device}: A streamed "
          f"{len(ra.tokens)} tokens through a drain, B->429, C->503, "
          f"drain_ok={srv.drain_ok}")
    return 0


def _poll(cond, what: str, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"{what} (within {timeout}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-url", default="http://127.0.0.1:8777")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--gen", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--ready-timeout", type=float, default=300.0,
                    help="how long to wait for the server subprocess to "
                         "come up (first compile is the slow part)")
    ap.add_argument("--probe-backpressure", action="store_true",
                    help="run the deterministic 429/503/drain probe "
                         "against an in-process server instead of "
                         "driving --base-url")
    ap.add_argument("--device", default="cuda",
                    help="--probe-backpressure: the engine's device, "
                         "'cuda', 'cuda:i' or 'cpu' (default: the card)")
    args = ap.parse_args(argv)
    if args.probe_backpressure:
        return probe_backpressure(args)
    return run_clients(args)


if __name__ == "__main__":
    raise SystemExit(main())
