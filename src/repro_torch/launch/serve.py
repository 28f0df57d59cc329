"""Serving CLI on torch: a thin driver over
:class:`repro_torch.launch.engine.ServeEngine`, the port of
``repro/launch/serve.py``'s local-request path.

Usage (on the card; ``--device cpu`` runs on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --device cuda --level O2 --kernels

``--mode {lockstep,donated,continuous,paged}`` picks the engine mode
(paged by default; lockstep and donated take one batch of uniform
prompts, so ``--requests`` must not exceed ``--batch``).  ``--level O2
--kernels`` runs the fused compounds and attention through the
hand-written Hopper kernels (``CompileOptions(level="O2",
use_pallas=True)``).  The workload is synthetic: ``--requests`` prompts
of ``--prompt-len`` tokens (``--shared-prefix-len`` of them identical, a
shared system prompt), ``--gen`` tokens each.  Weights are random from
``--seed``: the builder's numpy init at ``--reduced`` size, drawn on the
device at full width.  ``--report-json FILE`` dumps the
EngineReport; ``--smoke`` asserts the run is sane.

``--serve-http`` skips the synthetic workload and runs the asyncio front
door (:mod:`repro_torch.launch.server`) over the engine -- streaming
``POST /v1/generate``, ``GET /v1/metrics``, ``GET /healthz`` on
``--host``/``--port`` -- until SIGTERM/SIGINT, then drains gracefully
and (with ``--report-json``) writes the served-request report, results
keyed by the clients' tags.  It exits 1 when the drain left engine
state behind.  Only the continuous and paged modes can serve it.
``--tp`` comes with a later slice of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--mode", default="paged",
                    choices=("lockstep", "donated", "continuous", "paged"),
                    help="engine mode (default: paged)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="KV pool slots")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=None,
                    help="KV capacity per slot (default: prompt-len + gen)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu' (default: the card)")
    ap.add_argument("--level", default="O1", choices=("O0", "O1", "O2"),
                    help="pass-pipeline level")
    ap.add_argument("--kernels", action="store_true",
                    help="run the fused compounds through the Hopper "
                         "kernels (use_pallas=True)")
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--chunk-steps", type=int, default=None)
    ap.add_argument("--pages", type=int, default=None)
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per in-graph prefill dispatch "
                         "(default 4 pages; 0 = dense prefill)")
    ap.add_argument("--shared-prefix-len", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--request-timeout", type=float, default=None)
    ap.add_argument("--faults", default=None, metavar="SPEC")
    ap.add_argument("--faults-seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--report-json", metavar="FILE", default=None)
    ap.add_argument("--report-leg", default=None)
    ap.add_argument("--serve-http", action="store_true",
                    help="run the asyncio HTTP front door instead of a "
                         "synthetic workload (drains on SIGTERM/SIGINT)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777,
                    help="--serve-http listen port (0 = ephemeral)")
    ap.add_argument("--max-wait-queue", type=int, default=8,
                    help="--serve-http: accepted-but-unadmitted request "
                         "bound; beyond it new requests get 429")
    ap.add_argument("--max-body-bytes", type=int, default=1 << 20,
                    help="--serve-http: request bodies beyond this get 413")
    args = ap.parse_args(argv)

    if args.faults is not None:
        from .faults import configure
        configure(args.faults, args.faults_seed)

    from .. import kernels
    from ..backend import CompileOptions
    from ..configs import get_config
    from ..models.lm import build_dense_chunk
    from ..models.weights import init_params_on_device
    from .engine import EngineConfig, ServeEngine
    from .loadgen import make_prompts

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    n_req = args.requests or args.batch
    P, G = args.prompt_len, args.gen
    max_len = args.max_len or (P + G)
    if max_len < P + G:
        raise SystemExit(f"--max-len {max_len} < prompt-len + gen ({P + G})")
    if not 0 <= args.shared_prefix_len <= P:
        raise SystemExit(
            f"--shared-prefix-len {args.shared_prefix_len} must be in "
            f"[0, --prompt-len {P}]")
    if args.serve_http and args.mode not in ("continuous", "paged"):
        raise SystemExit(
            f"--serve-http needs a step()-capable engine "
            f"(--mode continuous|paged), got {args.mode!r}")
    paged = args.mode == "paged"
    try:
        econf = EngineConfig(
            mode=args.mode, slots=args.batch, max_len=max_len,
            seed=args.seed, page_size=args.page_size,
            chunk_steps=args.chunk_steps, pages=args.pages,
            device=args.device,
            prefix_sharing=(False if args.no_prefix_sharing else None),
            prefill_chunk=args.prefill_chunk)
        params = None
        if not args.reduced:   # full width: draw the weights on the device
            # every mode's graphs declare the same parameter names
            g = build_dense_chunk(cfg, max_len, args.batch, 1)
            params = init_params_on_device(g.builder, args.seed, args.device)
        engine = ServeEngine(cfg, dataclasses.replace(econf, params=params),
                             options=CompileOptions(level=args.level,
                                                    use_pallas=args.kernels))
    except ValueError as e:
        raise SystemExit(str(e))
    if args.serve_http:
        return _serve_http(engine, args, cfg, max_len)
    sampling = {}
    if args.temperature or args.top_k:
        sampling = dict(temperature=args.temperature, top_k=args.top_k)
    S = args.shared_prefix_len
    if not S:
        # the load generator's recipe, so a client of --serve-http sends
        # the prompts this path submits
        prompts = make_prompts(n_req, P, cfg.vocab, args.seed)
    else:
        rng = np.random.default_rng(args.seed)
        shared = rng.integers(0, cfg.vocab, size=(S,))
        prompts = [shared.copy() if S == P else np.concatenate(
            [shared, rng.integers(0, cfg.vocab, size=(P - S,))])
            for _ in range(n_req)]
    kernels.reset_counters()
    rids = [engine.submit(prompts[i], G,
                          deadline_s=args.request_timeout,
                          **(dict(sampling, key=i) if sampling else {}))
            for i in range(n_req)]
    rep = engine.run()
    counts = kernels.counters()

    print(f"[serve:{rep.mode}] {cfg.name} on {engine.device} "
          f"({args.level}{' kernels' if args.kernels else ''}): "
          f"{n_req} reqs x {G} tokens (prompt {P}, {args.batch} slots) in "
          f"{rep.wall_seconds:.2f}s ({rep.tok_s:.1f} tok/s e2e, "
          f"{rep.decode_tok_s:.1f} tok/s decode, p50 {rep.p50_ms:.2f}ms "
          f"p95 {rep.p95_ms:.2f}ms/token, ttft p50 {rep.ttft_p50_ms:.1f}ms "
          f"p95 {rep.ttft_p95_ms:.1f}ms, {rep.steps} steps, late admissions "
          f"{rep.late_admissions})")
    p = rep.pool
    if paged:
        print(f"[kv-pool:paged] slots={p.slots} pages={p.pages} "
              f"page_size={p.page_size} bytes/page={p.bytes_per_page} "
              f"in_use={p.pages_in_use} peak={p.peak_pages_in_use} "
              f"frag={p.fragmentation:.3f} page_allocs={p.page_allocs} "
              f"page_frees={p.page_frees} cow={p.cow_copies} "
              f"attach={p.shared_attaches} arena={p.decode_arena_bytes}B")
    elif p is not None:
        print(f"[kv-pool:{rep.mode}] slots={p.slots} "
              f"bytes/slot={p.bytes_per_slot} allocs={p.allocs} "
              f"frees={p.frees} peak_active={p.peak_active} "
              f"arena={p.decode_arena_bytes}B")
    if rep.kv_bytes_per_active_token is not None:
        print(f"[kv-bytes/active-token] {rep.kv_bytes_per_active_token:.1f}")
    print("[kernels] " + " ".join(
        f"{k}={c['launches']}/{c['rejected']}" for k, c in counts.items())
        + " (launches/rejected)")
    st = engine.cache_stats()
    print(f"[compile-cache] hits={st.hits} misses={st.misses} size={st.size}")
    for rid in rids[:2]:
        print(f"  req{rid}: {rep.results[rid][:12].tolist()} ...")

    if args.smoke:
        assert rep.tok_s > 0, "tok/s must be positive"
        assert all(len(rep.results[r]) == G for r in rids), \
            "every request must generate all tokens"
        if p is not None:
            assert p.allocs == n_req and p.frees == n_req, \
                f"allocs/frees must match requests ({p.allocs}/{p.frees})"
            assert p.active == 0, "the pool must return every slot"
            bad = engine.pool.verify()
            assert not bad, f"pool.verify() found: {bad}"
        if paged:
            assert p.pages_in_use == 0, \
                "paged pool must return every page when requests finish"
            assert p.page_allocs == p.page_frees and \
                p.ref_allocs == p.ref_frees
        if args.kernels and engine.device.type == "cuda":
            # flash attention runs where the graphs hold an Attention op
            # (every dense prefill, the lockstep/donated decode) at a
            # head width of a multiple of 128
            flash = cfg.head_dim % 128 == 0 and not (
                paged and engine.prefill_chunk)
            assert all(c["rejected"] == 0 for c in counts.values()), counts
            assert all(c["launches"] > 0 for k, c in counts.items()
                       if k != "flash_attention" or flash), counts
        print("[smoke] ok")
    if args.report_json:
        doc = dataclasses.asdict(rep)
        doc["leg"] = args.report_leg or rep.mode
        doc["results"] = {str(r): rep.results[r].tolist() for r in rids}
        doc["device"] = str(engine.device)
        doc["kernels"] = counts
        doc["workload"] = {"requests": n_req, "prompt_len": P, "gen": G,
                           "slots": args.batch, "max_len": max_len,
                           "seed": args.seed, "level": args.level,
                           "kernels": args.kernels,
                           "temperature": args.temperature,
                           "top_k": args.top_k, "shared_prefix_len": S,
                           "prefix_sharing": engine.prefix_sharing,
                           "prefill_chunk": engine.prefill_chunk}
        doc["pool_verify"] = (engine.pool.verify()
                              if engine.pool is not None else [])
        with open(args.report_json, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
        print(f"[report] wrote {args.report_json}")
    return 0


def _serve_http(engine, args, cfg, max_len) -> int:
    """The --serve-http path: front door up, drain on SIGTERM/SIGINT
    (the handlers go on the main thread's event loop), then print and
    emit the served-request report."""
    from .. import kernels
    from .server import ServeHTTPServer

    srv = ServeHTTPServer(engine, host=args.host, port=args.port,
                          max_wait_queue=args.max_wait_queue,
                          max_body_bytes=args.max_body_bytes)
    kernels.reset_counters()
    srv.serve_forever(on_ready=lambda: print(
        f"[serve-http:{engine.mode}] {cfg.name} on {engine.device} "
        f"({args.level}{' kernels' if args.kernels else ''}) listening on "
        f"{srv.base_url} (slots={args.batch} max_len={max_len} "
        f"wait_queue={args.max_wait_queue})", flush=True))
    counts = kernels.counters()

    snap = srv.stats.snapshot()
    print(f"[serve-http] drained: {snap['requests_completed']} completed / "
          f"{snap['requests_accepted']} accepted "
          f"(429s {snap['rejected_429']}, 503s {snap['rejected_503']}), "
          f"{snap['tokens_streamed']} tokens streamed, "
          f"ttft p50 {snap['ttft_p50_ms']:.1f}ms "
          f"p95 {snap['ttft_p95_ms']:.1f}ms, "
          f"tok p50 {snap['tok_p50_ms']:.1f}ms "
          f"p95 {snap['tok_p95_ms']:.1f}ms, "
          f"sustained {snap['sustained_tok_s']:.1f} tok/s, "
          f"drain_ok={srv.drain_ok}")
    print("[kernels] " + " ".join(
        f"{k}={c['launches']}/{c['rejected']}" for k, c in counts.items())
        + " (launches/rejected)")
    if args.report_json:
        doc = srv.report_doc()
        doc["leg"] = args.report_leg or doc.get("mode") or "server"
        doc["device"] = str(engine.device)
        doc["kernels"] = counts
        doc["workload"] = {"requests": args.requests or args.batch,
                           "prompt_len": args.prompt_len, "gen": args.gen,
                           "slots": args.batch, "max_len": max_len,
                           "seed": args.seed, "level": args.level,
                           "kernels": args.kernels,
                           "temperature": args.temperature,
                           "top_k": args.top_k}
        with open(args.report_json, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
        print(f"[report] wrote {args.report_json}")
    if not srv.drain_ok:
        print("[serve-http] ERROR: drain left engine state behind "
              "(see report)", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
