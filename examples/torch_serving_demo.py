"""Streaming tokens from the ServeEngine on torch (continuous batching):
the counterpart of ``examples/serving_demo.py``, every section on
``repro_torch``.

Three requests with different prompt/generation lengths share two KV
pool slots; tokens stream out as they are produced, and the third
request is admitted mid-flight the moment a slot frees up.

The second half re-runs the workload in ``paged`` mode: KV lives in a
shared page pool (pages allocated as each request's position crosses a
page boundary, returned on completion), the scheduler decodes
``chunk_steps`` tokens per dispatch, and sampling knobs (temperature /
top-k / PRNG key) are per-request graph inputs — greedy requests stay
token-for-token identical to continuous mode while the pool reserves
fewer KV bytes per token actually cached.

The third section puts the HTTP front door (``launch/server.py``) over
a paged engine and talks to it like a network client would: a streaming
``POST /v1/generate`` consumed token by token over SSE, a ``text``
prompt, and the ``GET /v1/metrics`` SLO snapshot — then drains the
server and shows the pool came back empty.

The fourth section exercises the fault-tolerance contract:
cancelling a mid-flight request at a chunk boundary (slot and pages
verifiably return), a per-request deadline expiring into its own
``deadline_exceeded`` terminal status, and a deterministic
``FaultInjector`` raising inside dispatch — contained into a structured
per-request failure with the engine degraded but still serving.

The fifth section is the prefix-sharing contract: three requests
with one identical 16-token system prompt run on a paged engine with
copy-on-write sharing on (the default) and off.  With sharing on, the
followers point their page tables at the publisher's hashed prefix
pages (``shared_attaches``), copy only on the first divergent write
(``cow_copies``), reserve far fewer KV bytes per active token — and
decode exactly the same greedy tokens, with every refcounted page
released on drain (``pool.verify()`` comes back empty).  Prompts are
prefilled in-graph in bounded chunks (``prefill_chunk``) rather than
one dense dispatch per prompt length.

The sixth section is the unified sharding API: one module
(``repro_torch.backend.sharding``) holds the pjit policies, mesh helpers, and
the partition profiles that drive the ``PartitionGraph`` pass —
``CompileOptions(mode="shardmap", partition="tp", mesh_shape=(N,))``
cuts a compiled graph into a per-device program with explicit AllGather
nodes (the exact column-parallel profile never splits a contraction,
so greedy decode stays bit-identical), and ``EngineConfig(tp=2)``
serves the paged engine tensor-parallel: each device holds half the KV
heads of every page while greedy tokens match ``tp=1`` exactly.  One
process drives both shards: with ``--device cpu`` both name the CPU, on
the card both share it through an explicit mesh.

The final section shows the fused-kernel layer underneath: compiling a
serve-family graph at O2 pattern-matches the unfused matmul chains into
SwiGLU / NormMatmul / RotaryQKV compound ops (per-compound hit counts
in the PipelineReport; ``use_pallas=True`` runs them through the
Hopper kernels on the card, their plain versions on the CPU), and
``autotune=True`` resolves the attention knobs and per-compound fusion
on/off from a recorded sweep — candidate 0 is always the request
as-given, so the selection can never be slower than not tuning.

Run:  PYTHONPATH=src python examples/torch_serving_demo.py [--device cpu]

Runs on the card unless ``--device cpu``.
"""
import argparse
import asyncio
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import loadgen  # noqa: E402
from repro_torch.launch.engine import ServeEngine  # noqa: E402
from repro_torch.launch.server import running_server  # noqa: E402


def fused_kernel_demo(cfg, device):
    import tempfile

    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs

    g = build_graphs(cfg, ShapeConfig("serve", "serve", 16, 2), 2)
    be = Backend.create("torch", fresh=True, device=device)
    # what the pattern-matcher finds, before the tuner weighs in
    cf = be.compile(g.fn, CompileOptions(level="O2", use_pallas=True))
    hits = dict(cf.report.stats)["fuse-compounds"]
    print("compounds fused at O2:",
          {k: v for k, v in hits.items() if v})
    # the tuner sweeps the attention knobs and per-compound on/off (the
    # kernel tiles and use_pallas are keyed, never swept) — candidate 0
    # is the request as-given, so the selection never loses to not tuning
    with tempfile.TemporaryDirectory() as cache_dir:
        cf = be.compile(g.fn, CompileOptions(
            level="O2", use_pallas=True, autotune=True,
            cache_dir=cache_dir))
        print(f"autotuned knobs: mm tiles "
              f"({cf.options.mm_bm}, {cf.options.mm_bn}, "
              f"{cf.options.mm_bk}), "
              f"fuse_swiglu={cf.options.fuse_swiglu} "
              f"fuse_norm_matmul={cf.options.fuse_norm_matmul}")
        st = be.cache_stats()
        print(f"sweeps={st.autotune_sweeps} (a second process would "
              f"re-resolve from the record with zero)")


def tensor_parallel_demo(cfg, device):
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.backend.sharding import make_mesh, partition_profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.engine import EngineConfig
    from repro_torch.models.lm import build_graphs

    # one API: the pass profile names the mesh axes and the rule table
    prof = partition_profile("tp")
    print(f"profile 'tp': axes={prof.axes} rules={prof.rules} "
          f"last_dim_only={prof.last_dim_only} (column-parallel only: "
          f"never splits a contraction, so greedy decode is bit-exact)")
    # the partition pass runs inside Backend.compile; on a trivial (1,)
    # mesh it only annotates — the stats show what a real mesh would cut
    g = build_graphs(cfg, ShapeConfig("serve", "serve", 16, 2), 2)
    cf = Backend.create("torch", fresh=True, device=device).compile(
        g.fn, CompileOptions(mode="shardmap", partition="tp",
                             mesh_shape=(1,), static_jit=False))
    print(f"pipeline stats['partition']: "
          f"{dict(cf.report.stats['partition'])}")
    # two shards driven by this process: on the CPU both name it; on a
    # card both share it through an explicit mesh (one card per shard
    # otherwise)
    opts = CompileOptions() if device == "cpu" else CompileOptions(
        mesh=make_mesh((2,), ("model",), devices=[device] * 2))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(6,)).astype(np.int32)

    def run(tp):
        eng = ServeEngine(cfg, EngineConfig(
            mode="paged", slots=2, max_len=24, seed=0, page_size=4,
            chunk_steps=4, tp=tp, device=device),
            options=opts if tp > 1 else None)
        rid = eng.submit(prompt, 8)
        rep = eng.run()
        return eng, rep, [int(t) for t in rep.results[rid]]

    e1, r1, t1 = run(1)
    e2, r2, t2 = run(2)
    st = e2.cf.report.stats["partition"]
    print(f"tp=1 tokens: {t1}")
    print(f"tp=2 tokens: {t2}  (identical: {t1 == t2})")
    print(f"partition stats: params_sharded={st['params_sharded']} "
          f"all_gather={st['all_gather']} "
          f"all_reduce={st.get('all_reduce', 0)} (exact profile: none)")
    print(f"kv bytes/device: {r2.kv_bytes_per_device} at tp=2 vs "
          f"{r1.kv_bytes_per_device} at tp=1 "
          f"(global pool {e2.pool.total_bytes}B, each device holds "
          f"{cfg.n_kv_heads // 2}/{cfg.n_kv_heads} kv heads of every page)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu' (default: the card)")
    device = ap.parse_args().device
    cfg = get_config("deepseek-7b").reduced()
    engine = ServeEngine(cfg, slots=2, max_len=24, mode="continuous", seed=0,
                         device=device)

    rng = np.random.default_rng(0)
    workload = [(rng.integers(0, cfg.vocab, size=(6,)), 8),
                (rng.integers(0, cfg.vocab, size=(4,)), 10),
                (rng.integers(0, cfg.vocab, size=(8,)), 6)]
    for prompt, max_new in workload:
        rid = engine.submit(prompt, max_new)
        print(f"submitted req{rid}: prompt={len(prompt)} gen={max_new}")

    print("--- streaming ---")
    for rid, token in engine.stream():
        print(f"req{rid} -> {token}")

    rep = engine.run()  # drained; returns the report
    print("--- report ---")
    print(f"{rep.generated_tokens} tokens, {rep.tok_s:.1f} tok/s e2e, "
          f"{rep.decode_tok_s:.1f} tok/s decode, "
          f"late admissions: {rep.late_admissions}")
    p = rep.pool
    print(f"kv pool: {p.slots} slots x {p.bytes_per_slot}B, "
          f"allocs={p.allocs} frees={p.frees} peak={p.peak_active}")
    kv_cont = rep.kv_bytes_per_active_token

    # --- paged mode: page-granular KV + chunked dispatch + sampling ---
    print("--- paged + sampling ---")
    paged = ServeEngine(cfg, slots=2, max_len=24, mode="paged", seed=0,
                        page_size=4, chunk_steps=4, device=device)
    greedy_rid = None
    for i, (prompt, max_new) in enumerate(workload):
        if i == 0:
            # stochastic request: reproducible via its PRNG key — resubmit
            # with the same key and you get the same tokens
            rid = paged.submit(prompt, max_new, temperature=0.8, top_k=16,
                               key=42)
            print(f"submitted req{rid}: temperature=0.8 top_k=16 key=42")
        else:
            rid = paged.submit(prompt, max_new)  # greedy (temperature 0)
            greedy_rid = rid
            print(f"submitted req{rid}: greedy")
    prep = paged.run()
    print(f"greedy req{greedy_rid} tokens: "
          f"{prep.results[greedy_rid].tolist()} "
          f"(identical to continuous mode)")
    pp = prep.pool
    print(f"paged pool: {pp.pages} pages x {pp.page_size} tokens, "
          f"peak {pp.peak_pages_in_use} in use, "
          f"page_allocs={pp.page_allocs} page_frees={pp.page_frees}, "
          f"fragmentation={pp.fragmentation:.2f}")
    print(f"kv bytes per active token: {prep.kv_bytes_per_active_token:.0f} "
          f"paged vs {kv_cont:.0f} continuous")

    # --- the HTTP front door: streaming clients over the network edge ---
    print("--- http server ---")
    engine = ServeEngine(cfg, slots=2, max_len=24, mode="paged", seed=0,
                         page_size=4, chunk_steps=4, device=device)
    with running_server(engine, max_wait_queue=4) as srv:
        print(f"listening on {srv.base_url}")
        # a token-ids client, streamed over SSE (chunked transfer)
        prompt, max_new = workload[0]
        res = asyncio.run(loadgen.stream_generate(
            srv.base_url, {"prompt": [int(t) for t in prompt],
                           "max_new": max_new, "tag": "demo"}))
        print(f"streamed {len(res.tokens)} tokens: {res.tokens} "
              f"(ttft {res.ttft_ms:.1f}ms)")
        # a text client: bytes folded into the vocabulary
        res = asyncio.run(loadgen.stream_generate(
            srv.base_url, {"text": "hello ngraph", "max_new": 6}))
        print(f"text prompt -> {res.tokens}")
        metrics = loadgen.fetch_json(srv.base_url, "/v1/metrics")
        s = metrics["server"]
        print(f"metrics: {s['requests_completed']} completed, "
              f"ttft p95 {s['ttft_p95_ms']:.1f}ms, "
              f"tok p95 {s['tok_p95_ms']:.2f}ms, "
              f"sustained {s['sustained_tok_s']:.1f} tok/s, "
              f"engine {metrics['engine']}")
    print(f"drained: drain_ok={srv.drain_ok} "
          f"pages_in_use={engine.pool.pages_in_use}")

    # --- fault tolerance: cancel, deadline, injected dispatch failure ---
    print("--- fault tolerance ---")
    from repro_torch.launch.faults import FaultInjector

    eng = ServeEngine(cfg, slots=2, max_len=40, mode="paged", seed=0,
                      page_size=4, chunk_steps=1, device=device)
    ra = eng.submit(workload[0][0], 24)
    rb = eng.submit(workload[1][0], 8)
    eng.step()  # both admitted, first tokens decoded
    eng.cancel(ra, "user hit stop")
    eng.step()  # the chunk boundary where the cancel lands
    req = eng._requests[ra]
    print(f"cancelled req{ra}: status={req.status!r} "
          f"kept {len(req.tokens)} tokens, pool active={eng.pool.active} "
          f"pages_in_use={eng.pool.pages_in_use}")
    rd = eng.submit(workload[2][0], 24, deadline_s=30.0)
    eng.step()
    eng._requests[rd].deadline = 0.0  # force expiry for the demo
    rep = eng.run()
    print(f"deadline req{rd}: status={rep.statuses[rd]!r} "
          f"({rep.errors[rd]})")
    print(f"survivor req{rb}: status={rep.statuses[rb]!r}, "
          f"counters={rep.counters}")

    # inject a dispatch failure on a fresh engine: the in-flight request
    # fails with a structured error, the engine degrades but keeps serving
    eng = ServeEngine(cfg, slots=2, max_len=40, mode="paged", seed=0,
                      page_size=4, chunk_steps=1, device=device,
                      faults=FaultInjector("dispatch.raise=after:2"))
    ri = eng.submit(workload[0][0], 8)
    eng.step()
    eng.step()  # injected FaultError, contained
    print(f"injected req{ri}: status={eng._requests[ri].status!r} "
          f"health={eng.health!r}")
    rb2 = eng.submit(workload[1][0], 6)
    rep = eng.run()
    print(f"degraded engine still serves: req{rb2} -> "
          f"{rep.results[rb2].tolist()} "
          f"(pages_in_use={eng.pool.pages_in_use})")

    # --- prefix sharing: COW pages under a shared system prompt ---
    print("--- prefix sharing ---")
    sys_prompt = rng.integers(0, cfg.vocab, size=(16,)).astype(np.int32)

    def shared_run(sharing):
        # prefix_sharing defaults on for paged; prefill_chunk defaults
        # to 4 * page_size, so the 16-token prompt prefills in-graph
        eng = ServeEngine(cfg, slots=3, max_len=24, mode="paged", seed=0,
                          page_size=4, chunk_steps=2, device=device,
                          prefix_sharing=sharing)
        rids = [eng.submit(sys_prompt, 4) for _ in range(3)]
        return eng, rids, eng.run()

    eng, rids, rep = shared_run(True)
    p = rep.pool
    print(f"3 requests x one 16-token system prompt: "
          f"shared_attaches={p.shared_attaches} cow_copies={p.cow_copies} "
          f"peak {p.peak_pages_in_use} pages")
    _, urids, urep = shared_run(False)
    print(f"kv bytes per active token: "
          f"{rep.kv_bytes_per_active_token:.0f} shared vs "
          f"{urep.kv_bytes_per_active_token:.0f} unshared "
          f"(peak {urep.pool.peak_pages_in_use} pages)")
    same = all(np.array_equal(rep.results[s], urep.results[u])
               for s, u in zip(rids, urids))
    print(f"token parity with sharing off: {same}, drained "
          f"pages_in_use={eng.pool.pages_in_use}, "
          f"verify() -> {eng.pool.verify()}")

    # --- tensor-parallel serving through the unified sharding API ---
    print("--- tensor parallel ---")
    tensor_parallel_demo(cfg, device)

    # --- fused compound kernels + the autotuned knob resolution ---
    print("--- fused kernels ---")
    fused_kernel_demo(cfg, device)


if __name__ == "__main__":
    main()
