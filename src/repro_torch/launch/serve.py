"""Serving CLI on torch: a thin driver over
:class:`repro_torch.launch.engine.ServeEngine` (paged mode), the port of
``repro/launch/serve.py``'s local-request path.

Usage (on the card; ``--device cpu`` runs on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --device cuda --level O2 --kernels

``--level O2 --kernels`` runs the fused compounds through the
hand-written Hopper kernels (``CompileOptions(level="O2",
use_pallas=True)``).  The workload is synthetic: ``--requests`` prompts
of ``--prompt-len`` tokens (``--shared-prefix-len`` of them identical, a
shared system prompt), ``--gen`` tokens each.  Weights are random from
``--seed``: the builder's numpy init at ``--reduced`` size, drawn on the
device at full width.  ``--report-json FILE`` dumps the
EngineReport; ``--smoke`` asserts the run is sane.  The HTTP front door
(``--serve-http``) and ``--tp`` come with later slices of the port.
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
    try:
        econf = EngineConfig(
            mode="paged", slots=args.batch, max_len=max_len, seed=args.seed,
            page_size=args.page_size, chunk_steps=args.chunk_steps,
            pages=args.pages, device=args.device,
            prefix_sharing=(False if args.no_prefix_sharing else None),
            prefill_chunk=args.prefill_chunk)
        params = None
        if not args.reduced:   # full width: draw the weights on the device
            g = build_dense_chunk(
                cfg, max_len, args.batch, econf.chunk_steps or 4,
                page_size=econf.page_size or 8)
            params = init_params_on_device(g.builder, args.seed, args.device)
        engine = ServeEngine(cfg, dataclasses.replace(econf, params=params),
                             options=CompileOptions(level=args.level,
                                                    use_pallas=args.kernels))
    except ValueError as e:
        raise SystemExit(str(e))
    sampling = {}
    if args.temperature or args.top_k:
        sampling = dict(temperature=args.temperature, top_k=args.top_k)
    rng = np.random.default_rng(args.seed)
    S = args.shared_prefix_len
    shared = rng.integers(0, cfg.vocab, size=(S,)) if S else None
    prompts = []
    for _ in range(n_req):
        if S == P:
            prompts.append(shared.copy())
        elif S:
            prompts.append(np.concatenate(
                [shared, rng.integers(0, cfg.vocab, size=(P - S,))]))
        else:
            prompts.append(rng.integers(0, cfg.vocab, size=(P,)))
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
    print(f"[kv-pool:paged] slots={p.slots} pages={p.pages} "
          f"page_size={p.page_size} bytes/page={p.bytes_per_page} "
          f"in_use={p.pages_in_use} peak={p.peak_pages_in_use} "
          f"frag={p.fragmentation:.3f} page_allocs={p.page_allocs} "
          f"page_frees={p.page_frees} cow={p.cow_copies} "
          f"attach={p.shared_attaches} arena={p.decode_arena_bytes}B")
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
        assert p.allocs == n_req and p.frees == n_req, \
            f"allocs/frees must match requests ({p.allocs}/{p.frees})"
        assert p.active == 0 and p.pages_in_use == 0, \
            "paged pool must return every page when requests finish"
        assert p.page_allocs == p.page_frees and p.ref_allocs == p.ref_frees
        bad = engine.pool.verify()
        assert not bad, f"pool.verify() found: {bad}"
        if args.kernels and engine.device.type == "cuda":
            assert all(c["launches"] > 0 and c["rejected"] == 0
                       for c in counts.values()), counts
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
        doc["pool_verify"] = engine.pool.verify()
        with open(args.report_json, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
        print(f"[report] wrote {args.report_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
