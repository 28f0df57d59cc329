"""Serving CLI on torch: a thin driver over
:class:`repro_torch.launch.engine.ServeEngine`, the port of
``repro/launch/serve.py``'s local-request path.

Usage (on the card; ``--device cpu`` runs on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --device cuda --level O2 --kernels

``--mode {lockstep,donated,continuous,paged}`` picks the engine mode
(continuous by default, paged with ``--serve-http``, as in the
reference; lockstep and donated take one batch of uniform prompts, so
``--requests`` must not exceed ``--batch``; ``--temperature``,
``--top-k`` and the page, chunk and prefill flags need paged).
``--level O2 --kernels`` runs the fused compounds and attention through
the hand-written Hopper kernels (``CompileOptions(level="O2",
use_pallas=True)``).  The workload is synthetic: ``--requests`` prompts
of ``--prompt-len`` tokens (``--shared-prefix-len`` of them identical, a
shared system prompt), ``--gen`` tokens each.  Weights are random from
``--seed``: the builder's numpy init at ``--reduced`` size, drawn on the
device at full width.  ``--report-json FILE`` dumps the
EngineReport; ``--smoke`` asserts the run is sane.

``--cache-dir DIR`` (default ``$REPRO_CACHE_DIR``) persists every graph's
optimized form on disk, so a second process skips the pass pipeline;
``--autotune`` resolves the attention and fusion knobs by a sweep whose
record persists there too.  ``--min-disk-hits N`` asserts that a warm run
took at least N graphs from disk and, with ``--autotune``, swept none.

``--serve-http`` skips the synthetic workload and runs the asyncio front
door (:mod:`repro_torch.launch.server`) over the engine -- streaming
``POST /v1/generate``, ``GET /v1/metrics``, ``GET /healthz`` on
``--host``/``--port`` -- until SIGTERM/SIGINT, then drains gracefully
and (with ``--report-json``) writes the served-request report, results
keyed by the clients' tags.  It exits 1 when the drain left engine
state behind.  Only the continuous and paged modes can serve it.

``--tp N`` (paged mode) shards the chunk and prefill graphs and the KV
pool's kv_heads dim over N shards, greedy outputs token-identical to
``--tp 1``; it prints a ``[kv-pool:tp]`` line.  With ``--device cpu``
the N shards run on the CPU, with no flags:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --reduced --mode paged --tp 2 --device cpu

On the card the mesh needs N cards (``chip_smoke.py --tp-only`` runs
two shards on one card through an explicit mesh).

The families other than dense (``--arch mixtral-8x22b``,
``deepseek-v3-671b``, ``recurrentgemma-9b``, ``xlstm-350m``,
``whisper-medium``, ``llama-3.2-vision-11b``) serve through lockstep
only, as in the reference: without ``--mode`` the CLI says so and falls
back to it, and ``--mode paged`` is refused:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
      --reduced --mode lockstep --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
      --device cuda --level O2 --kernels --mode lockstep

(the last at full width on the card, weights drawn there).  The
recurrent families' decode starts its recurrent states from zeros: the
reference's prefill exports only rg's attention caches and none of
xlstm's states.  Likewise the multimodal families' decode cross-attends
over zeros: their prefill exports the self-attention caches, not
whisper's encoder projections nor vlm's image keys and values.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, List, Optional

import numpy as np


def full_width_builder(cfg, max_len: int, batch: int):
    """The builder that declares a full-width engine's parameters: the
    config family's own decode graph (every graph an engine of that family
    compiles reads the same names), or for the multimodal families its
    prefill graph, which declares the decode graph's names and the
    encoder's (whisper) or the vision projection's (vlm) besides."""
    from ..configs.base import ShapeConfig
    from ..models.lm import build_graphs
    kind = "prefill" if cfg.family in ("encdec", "vlm") else "decode"
    return build_graphs(cfg, ShapeConfig(kind, kind, max_len, batch),
                        batch).builder


def smoke_kernels(cfg, attention: bool = True, train: bool = False):
    """(the kernels a path of ``cfg`` on the card must launch, the kernels
    allowed to refuse a shape there) -- the one statement of this rule,
    which the serving smoke, the parity script, ``chip_smoke.py`` and the
    card tests read.  Every path launches matmul.  RMSNorm configs launch
    rmsnorm and norm_matmul; a LayerNorm config (whisper) launches
    neither, its norms being torch ops (the reference has no Pallas
    LayerNorm either).  SwiGLU runs where the MLP is one: not in a GeLU
    MLP (whisper), nor in mixtral's experts (batched einsums, so a moe
    config without a shared expert runs none), nor in xlstm, whose FFN
    is GeLU-gated.  Flash attention runs where the path's graphs hold an
    Attention op (``attention``; the paged path's chunked prefill holds
    none, and no xlstm graph does: its mLSTM attends through einsums) at
    a query head width the emitter offers it (whisper's 64 too, over its
    1500 encoder frames; vlm's over 1601 image tokens), and refuses
    MLA's absorbed decode, whose latent head (kv_lora + d_rope) is wider
    than the kernel takes.  Nothing else is refused at full width:
    xlstm's input/forget gate projection (N = 2 x heads = 8) is one
    16-byte bf16 vector wide, which the matmul kernel takes.  The
    fixed-order batched kernel takes every floating contraction that is
    not the matmul kernel's 2-D product: the paged and row-position
    attention compositions (a path without an Attention op), the
    experts of moe and mla_moe (and MLA's absorbed products), the
    recurrent families' block products, a tied unembedding (the pass
    pipeline folds the table's transpose into the dot, which contracts
    over the table's second axis), and in every family a train step's
    backward (``train``: products against transposed weights and
    activations); it takes every float shape, so it refuses nothing."""
    from ..transformers.torch_emit import FLASH_HEAD_MULTIPLE
    need = {"matmul"}
    if cfg.norm == "rms":
        need |= {"norm_matmul", "rmsnorm"}
    if cfg.mlp == "swiglu" and (cfg.family not in ("moe", "xlstm")
                                or cfg.n_shared_experts):
        need.add("swiglu")
    width = cfg.d_nope + cfg.d_rope if cfg.mla else cfg.head_dim
    if attention and cfg.family != "xlstm" and \
            width % FLASH_HEAD_MULTIPLE == 0:
        need.add("flash_attention")
    if not attention or train or cfg.tie_embeddings or cfg.family in (
            "moe", "mla_moe", "rg_hybrid", "xlstm"):
        need.add("batched_matmul")
    return need, ({"flash_attention"} if cfg.mla else set())


def workload_prompts(cfg, n_req: int, prompt_len: int, shared: int,
                     seed: int) -> List[np.ndarray]:
    """The CLI's synthetic prompts: the load generator's recipe (so a
    client of --serve-http sends the prompts the local path submits), or
    with ``shared`` > 0 one drawn prefix of that many tokens that every
    prompt starts with."""
    from .loadgen import make_prompts
    if not shared:
        return make_prompts(n_req, prompt_len, cfg.vocab, seed)
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab, size=(shared,))
    return [head.copy() if shared == prompt_len else np.concatenate(
        [head, rng.integers(0, cfg.vocab, size=(prompt_len - shared,))])
        for _ in range(n_req)]


def engine_report(engine, rep, rids, counts, args, n_req: int,
                  max_len: int) -> dict:
    """An engine leg's ``--report-json`` document, the shape
    ``scripts/check_serving_matrix.py`` reads: the EngineReport, the
    tokens keyed by request id, the kernels' counts of the run and the
    workload, ``tp`` included."""
    doc = dataclasses.asdict(rep)
    doc["leg"] = args.report_leg or rep.mode
    doc["results"] = {str(r): rep.results[r].tolist() for r in rids}
    doc["device"] = str(engine.device)
    doc["kernels"] = counts
    doc["workload"] = {"requests": n_req, "prompt_len": args.prompt_len,
                       "gen": args.gen, "slots": args.batch,
                       "max_len": max_len, "seed": args.seed,
                       "level": args.level, "kernels": args.kernels,
                       "temperature": args.temperature,
                       "top_k": args.top_k,
                       "shared_prefix_len": args.shared_prefix_len,
                       "prefix_sharing": engine.prefix_sharing,
                       "prefill_chunk": engine.prefill_chunk,
                       "tp": engine.tp}
    doc["pool_verify"] = (engine.pool.verify()
                          if engine.pool is not None else [])
    return doc


def write_report(doc: dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    print(f"[report] wrote {path}")


def main(argv: Optional[List[str]] = None, *, cfg=None, params=None,
         mesh=None, drive: Optional[Callable[[str], None]] = None) -> int:
    """The CLI.  An in-process caller (``scripts/torch_serving_matrix.py``)
    may pass the model config (``cfg``, e.g. cut in depth; ``--arch`` and
    ``--reduced`` then only say how the weights are drawn), the weights
    (``params``, by name), the tensor-parallel mesh (``mesh``, e.g. two
    shards on one card) and, with ``--serve-http``, ``drive``: called
    with the server's base URL once it listens, in place of waiting for
    SIGTERM; the server drains when it returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--mode", default=None,
                    choices=("lockstep", "donated", "continuous", "paged"),
                    help="engine mode (default: continuous; paged when "
                         "--serve-http)")
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
    ap.add_argument("--tp", type=int, default=1,
                    help="paged mode: tensor-parallel width -- shard the "
                         "chunk/prefill graphs and the KV pool's kv_heads "
                         "dim over a tp-shard mesh (greedy outputs stay "
                         "token-identical to tp=1; with --device cpu the "
                         "shards run on the CPU, on cuda the mesh needs "
                         "tp cards)")
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
    ap.add_argument("--cache-dir", default=None,
                    help="persistent compile-cache dir (default: "
                         "$REPRO_CACHE_DIR if set, else disabled)")
    ap.add_argument("--autotune", action="store_true",
                    help="resolve attn_impl/attn_chunk and the fusion "
                         "flips via the autotuner (record persisted into "
                         "--cache-dir)")
    ap.add_argument("--min-disk-hits", type=int, default=None, metavar="N",
                    help="assert >= N persistent-cache disk hits (the "
                         "second run of an unchanged graph must "
                         "warm-start)")
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
    from ..models.weights import init_params_on_device
    from .engine import EngineConfig, ServeEngine

    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    n_req = args.requests or args.batch
    P, G = args.prompt_len, args.gen
    max_len = args.max_len or (P + G)
    if max_len < P + G:
        raise SystemExit(f"--max-len {max_len} < prompt-len + gen ({P + G})")
    mode = args.mode or ("paged" if args.serve_http else "continuous")
    if args.serve_http and mode not in ("continuous", "paged"):
        raise SystemExit(
            f"--serve-http needs a step()-capable engine "
            f"(--mode continuous|paged), got {mode!r}")
    if cfg.family != "dense" and mode != "lockstep":
        if mode == "paged":
            # an explicit paged request must not silently fall back to a
            # mode that ignores its page/sampling flags
            raise SystemExit(
                f"--mode paged needs the dense family's serve graphs; "
                f"{cfg.name} ({cfg.family}) only serves via "
                f"--mode lockstep")
        print(f"[serve] {cfg.name} ({cfg.family}): no serve/chunk graphs "
              f"yet, falling back to --mode lockstep")
        mode = "lockstep"
    if mode != "paged" and (args.temperature or args.top_k):
        # never silently decode greedy when the user asked for sampling
        raise SystemExit(
            f"--temperature/--top-k need --mode paged (in-graph sampling); "
            f"mode {mode!r} decodes greedily")
    if mode != "paged" and any(v is not None for v in
                               (args.page_size, args.chunk_steps,
                                args.pages, args.prefill_chunk)):
        raise SystemExit(
            f"--page-size/--chunk-steps/--pages/--prefill-chunk need "
            f"--mode paged; mode {mode!r} uses fixed per-slot cache rows")
    if mode != "paged" and args.no_prefix_sharing:
        raise SystemExit(
            f"--no-prefix-sharing needs --mode paged; mode {mode!r} "
            f"never shares KV pages")
    if not 0 <= args.shared_prefix_len <= P:
        raise SystemExit(
            f"--shared-prefix-len {args.shared_prefix_len} must be in "
            f"[0, --prompt-len {P}]")
    paged = mode == "paged"
    try:
        econf = EngineConfig(
            mode=mode, slots=args.batch, max_len=max_len,
            seed=args.seed, page_size=args.page_size,
            chunk_steps=args.chunk_steps, pages=args.pages,
            device=args.device, tp=args.tp,
            prefix_sharing=(False if args.no_prefix_sharing else None),
            prefill_chunk=args.prefill_chunk, cache_dir=args.cache_dir,
            autotune=args.autotune)
        if params is None and not args.reduced:
            # full width: draw the weights on the device
            # every mode's graphs declare the parameter names of the
            # family's own decode graph
            params = init_params_on_device(
                full_width_builder(cfg, max_len, args.batch), args.seed,
                args.device)
        engine = ServeEngine(cfg, dataclasses.replace(econf, params=params),
                             options=CompileOptions(level=args.level,
                                                    use_pallas=args.kernels,
                                                    mesh=mesh))
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    if args.serve_http:
        return _serve_http(engine, args, cfg, max_len, drive)
    sampling = {}
    if paged and (args.temperature or args.top_k):
        sampling = dict(temperature=args.temperature, top_k=args.top_k)
    S = args.shared_prefix_len
    prompts = workload_prompts(cfg, n_req, P, S, args.seed)
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
        if rep.tp > 1:
            print(f"[kv-pool:tp] tp={rep.tp} "
                  f"bytes/device={rep.kv_bytes_per_device} "
                  f"(global {p.total_bytes}B)")
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
    print(f"[compile-cache] hits={st.hits} misses={st.misses} size={st.size} "
          f"disk_hits={st.disk_hits} disk_misses={st.disk_misses} "
          f"disk_evictions={st.disk_evictions} "
          f"autotune_hits={st.autotune_hits} "
          f"autotune_sweeps={st.autotune_sweeps}")
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
            need, may_refuse = smoke_kernels(
                cfg, attention=not (paged and engine.prefill_chunk))
            assert all(c["rejected"] == 0 for k, c in counts.items()
                       if k not in may_refuse), counts
            assert all(counts[k]["launches"] > 0 for k in need), counts
        print("[smoke] ok")
    if args.report_json:
        write_report(engine_report(engine, rep, rids, counts, args, n_req,
                                   max_len), args.report_json)
    if args.min_disk_hits is not None:
        assert st.disk_hits >= args.min_disk_hits, (
            f"expected >= {args.min_disk_hits} persistent-cache disk hits, "
            f"got {st.disk_hits} (misses={st.disk_misses}) — the warm run "
            f"did not reuse the on-disk compile cache")
        if args.autotune:
            assert st.autotune_sweeps == 0, (
                f"warm run re-swept {st.autotune_sweeps} graphs — tuning "
                f"records were not reused")
        print(f"[disk-cache] ok ({st.disk_hits} hits, "
              f"{st.autotune_sweeps} sweeps)")
    return 0


def _serve_http(engine, args, cfg, max_len, drive=None) -> int:
    """The --serve-http path: front door up, drain on SIGTERM/SIGINT
    (the handlers go on the main thread's event loop) or, for an
    in-process caller, once ``drive(base_url)`` returns; then print and
    emit the served-request report."""
    from .. import kernels
    from .server import ServeHTTPServer

    srv = ServeHTTPServer(engine, host=args.host, port=args.port,
                          max_wait_queue=args.max_wait_queue,
                          max_body_bytes=args.max_body_bytes)

    def ready():
        print(f"[serve-http:{engine.mode}] {cfg.name} on {engine.device} "
              f"({args.level}{' kernels' if args.kernels else ''}) "
              f"listening on {srv.base_url} (slots={args.batch} "
              f"max_len={max_len} wait_queue={args.max_wait_queue})",
              flush=True)

    kernels.reset_counters()
    if drive is None:
        srv.serve_forever(on_ready=ready)
    else:
        srv.start_in_thread()
        ready()
        try:
            drive(srv.base_url)
        finally:
            srv.shutdown()
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
        write_report(doc, args.report_json)
    if not srv.drain_ok:
        print("[serve-http] ERROR: drain left engine state behind "
              "(see report)", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
