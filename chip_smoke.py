"""Chip smoke test of the torch port on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --kernels-only   # phases 1-3, no result line

Phases, one line each; any failure raises and the script exits non-zero
without printing a result:

  1. device   -- the card's name and power limit (nvidia-smi) and torch's
                 name for it;
  2. build    -- nvcc builds the four Hopper kernels from
                 src/repro_torch/kernels/csrc/ (sm_90a) at first use;
  3. kernels  -- each kernel against its plain PyTorch version at the
                 full-width deepseek-7b shapes of the paged serving path
                 (bf16, plus one f32 case), with its time, the plain
                 version's, a one-call PyTorch yardstick's where there is
                 one, and the card's bound for the same work;
  4. main     -- ServeEngine(mode="paged") at O2 with the kernels on
                 full-width deepseek-7b (30 layers, d_model 4096, vocab
                 102400, f32 params drawn on the card from a seed):
                 6 greedy requests, two sharing a 32-token prefix, run to
                 drain; every kernel must have launched on this path and
                 none may have been refused;
  5. parity   -- reduced deepseek-7b (d_model 128, d_head 64, d_ff 256)
                 with the same numpy weights and prompts through the port
                 on the card (kernels) and on the CPU (plain versions):
                 greedy tokens must be identical.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense tensor core / f32 CUDA core
TOL = {torch.bfloat16: 3e-2, torch.float16: 3e-2, torch.float32: 1e-4}
D, F, V, SLOTS, CHUNK = 4096, 11008, 102400, 4, 64
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:20",
    "norm_matmul": "src/repro/kernels/norm_matmul.py:21",
    "swiglu": "src/repro/kernels/swiglu.py:22",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:18",
}


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- 1. device -----------------------------------------------------------------
def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", smi=repr(smi), torch=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    return smi


# -- 2. build --------------------------------------------------------------------
def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.lib()
    secs = time.perf_counter() - t0
    log = "\n".join(_build.build_log)
    spills, entry = [], ""
    for ln in log.splitlines():   # ptxas -v: entry name, then its spills
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "spill" in ln and not ln.strip().startswith("0 bytes"):
            spills.append(f"{entry[:60]}: {ln.strip()}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.BUILD_DIR, "ptxas.log"), "w") as f:
        f.write(log)
    say("build", seconds=f"{secs:.2f}", sources=len(_build.sources()),
        library=os.path.basename(lib._name), spilling_kernels=len(spills),
        spills=json.dumps(spills))


# -- 3. kernels ------------------------------------------------------------------
def _events_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events and each preceded by a write of ``flush`` (larger than the
    50 MB L2), so the weights come from device memory as they do on the
    serving path, where each layer's weights are new."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _bound(nbytes: int, flops: int, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rand(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def kernel_cases(gen):
    """(kernel, label, kernel_fn, plain_fn, library_fn, bytes, flops, dtype)
    at the shapes the paged serving path gives each kernel: decode (4
    slots) first -- the case the result line reports -- then prefill (a
    64-row chunk) and the f32 case."""
    from repro_torch.kernels import matmul as km, norm_matmul as kn
    from repro_torch.kernels import rmsnorm as kr, swiglu as ks
    from repro_torch.kernels import ref
    import torch.nn.functional as Fn
    bf, f32 = torch.bfloat16, torch.float32
    cases = []

    def mm(label, M, K, N, dt):
        a = _rand((M, K), dt, gen)
        b = _rand((K, N), dt, gen, K ** -0.5)
        s = a.element_size()
        cases.append(("matmul", label, lambda: km.matmul(a, b),
                      lambda: ref.matmul_ref(a, b), lambda: torch.matmul(a, b),
                      (M * K + K * N + M * N) * s, 2 * M * K * N, dt))

    def nm(label, M, N, g_dt):
        x = _rand((M, D), bf, gen)
        g = (1 + 0.1 * _rand((D,), f32, gen)).to(g_dt)
        w = _rand((D, N), bf, gen, D ** -0.5)
        cases.append(("norm_matmul", label,
                      lambda: kn.norm_matmul(x, g, w, 1e-6),
                      lambda: ref.norm_matmul_ref(x, g, w, 1e-6), None,
                      (M * D + D * N + M * N) * 2 + D * g.element_size(),
                      2 * M * D * N + 4 * M * D, bf))

    def sw(label, M, dt):
        x = _rand((M, D), dt, gen)
        wg = _rand((D, F), dt, gen, D ** -0.5)
        wu = _rand((D, F), dt, gen, D ** -0.5)
        wd = _rand((F, D), dt, gen, F ** -0.5)
        s = x.element_size()
        cases.append(("swiglu", label, lambda: ks.swiglu(x, wg, wu, wd),
                      lambda: ref.swiglu_ref(x, wg, wu, wd), None,
                      (M * D + 3 * D * F + M * D) * s,
                      6 * M * D * F + 4 * M * F, dt))

    def rn(label, M, w_dt):
        x = _rand((M, D), bf, gen)
        w = (1 + 0.1 * _rand((D,), f32, gen)).to(w_dt)
        lib = (lambda: Fn.rms_norm(x, (D,), w, 1e-6)) if w_dt == bf else None
        cases.append(("rmsnorm", label, lambda: kr.rmsnorm(x, w, 1e-6),
                      lambda: ref.rmsnorm_ref(x, w, 1e-6), lib,
                      2 * M * D * 2 + D * w.element_size(), 4 * M * D, bf))

    mm("decode wo (4x4096)@(4096x4096)", SLOTS, D, D, bf)
    mm("prefill wo (64x4096)@(4096x4096)", CHUNK, D, D, bf)
    mm("prefill unembed (1x4096)@(4096x102400)", 1, D, V, bf)
    mm("f32 (4x4096)@(4096x4096)", SLOTS, D, D, f32)
    nm("decode qkv (4x4096)(4096x4096)", SLOTS, D, bf)
    nm("decode final+unembed (4x4096)(4096x102400) g f32", SLOTS, V, f32)
    nm("prefill qkv (64x4096)(4096x4096)", CHUNK, D, bf)
    sw("decode (4x4096) F=11008", SLOTS, bf)
    sw("prefill (64x4096) F=11008", CHUNK, bf)
    rn("decode pre-MLP (4x4096)", SLOTS, bf)
    rn("prefill final (64x4096) w f32", CHUNK, f32)
    return cases


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    report = {}
    for name, label, kfn, pfn, lfn, nbytes, flops, dt in kernel_cases(gen):
        out = kfn()
        torch.cuda.synchronize()
        plain = pfn()
        torch.cuda.synchronize()
        require(out.shape == plain.shape and out.dtype == plain.dtype,
                f"{name} {label}: {out.shape} {out.dtype} vs plain "
                f"{plain.shape} {plain.dtype}")
        o, p = out.double(), plain.double()
        require(bool(torch.isfinite(o).all()), f"{name} {label}: non-finite")
        err = float((o - p).abs().max())
        scale = max(float(p.abs().max()), 1.0)
        require(err <= TOL[out.dtype] * scale,
                f"{name} {label}: max |kernel - plain| {err} > "
                f"{TOL[out.dtype]} x {scale}")
        ms = _events_ms(kfn, 20, flush)
        plain_ms = _events_ms(pfn, 5, flush)
        lib_ms = _events_ms(lfn, 20, flush) if lfn is not None else None
        bound_ms, bound_by = _bound(nbytes, flops, dt)
        say("kernel", name=name, case=repr(label), max_abs_err=f"{err:.3e}",
            tol=f"{TOL[out.dtype] * scale:.3e}", kernel_ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}" if lib_ms is not None else None,
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            bound_share=f"{bound_ms / ms:.3f}")
        if name not in report:   # the decode case is the reported one
            report[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
    del flush
    torch.cuda.empty_cache()
    return report


# -- 4. main path, full width --------------------------------------------------
def _prompts(vocab: int, lengths, shared: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ps = [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]
    ps[2][:shared] = ps[1][:shared]      # a shared system prompt
    return ps


def _dispatch_profile(eng) -> dict:
    """Two more decode dispatches, outside the counted run.  The first
    times the host: how long the emitter takes to enqueue the dispatch
    (``host_ms``) against its wall time to the tokens (``wall_ms``).  The
    second runs under ``torch.profiler`` (CUDA activity only) and sums
    the kernels' device time (``busy_ms``): busy well below wall means
    the card waits on the host."""
    from repro_torch.devices import to_numpy

    def dispatch():
        return eng.cf.raw(eng._tok, eng._pos, eng.pool.page_table,
                          eng._temp, eng._topk, eng._key,
                          *eng.pool.buffers, *eng.tparams)

    torch.cuda.synchronize()
    h0 = time.perf_counter()
    outs = dispatch()
    h1 = time.perf_counter()
    to_numpy(outs[0])
    h2 = time.perf_counter()
    del outs
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        to_numpy(dispatch()[0])
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"host_ms": (h1 - h0) * 1e3, "wall_ms": (h2 - h0) * 1e3,
            "busy_ms": f"{busy:.1f}" if rows else "not measured",
            "n_kernels": sum(r[1] for r in rows),
            "top": [[k[:48], round(ms, 3), n] for ms, n, k in rows[:8]]}


def phase_main(report: dict) -> None:
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    from repro_torch.models.lm import build_dense_chunk
    from repro_torch.models.weights import init_params_on_device

    cfg = get_config("deepseek-7b")
    require((cfg.n_layers, cfg.d_model, cfg.vocab) == (30, D, V),
            f"deepseek-7b config changed: {cfg}")
    ecfg = dict(mode="paged", slots=SLOTS, max_len=256, page_size=16,
                chunk_steps=4, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    builder = build_dense_chunk(cfg, 256, SLOTS, 4, page_size=16).builder
    params = init_params_on_device(builder, 0, "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in params.values())
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, EngineConfig(params=params, **ecfg),
                      options=CompileOptions(level="O2", use_pallas=True))
    t_engine = time.perf_counter() - t0
    prompts = _prompts(cfg.vocab, (17, 33, 48, 64, 81, 100), 32)
    kernels.reset_counters()
    rids = [eng.submit(p, 16) for p in prompts]
    rep = eng.run()
    torch.cuda.synchronize()
    counts = kernels.counters()
    require(all(rep.statuses[r] == "completed" for r in rids),
            f"statuses {rep.statuses}")
    for r, p in zip(rids, prompts):
        toks = rep.results[r]
        require(len(toks) == 16 and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab, f"request {r}: {toks}")
    require(rep.pool.pages_in_use == 0, f"pages leaked: {rep.pool}")
    problems = eng.pool.verify()
    require(problems == [], f"pool.verify(): {problems}")
    require(rep.pool.shared_attaches > 0, "no prefix page was shared")
    for name, c in counts.items():
        require(c["launches"] > 0, f"{name}: no launch on the main path")
        require(c["rejected"] == 0, f"{name}: {c['rejected']} refusals")
        report[name]["launches"] = c["launches"]
    pipeline_s = eng.cf.report.seconds + sum(
        v[1].report.seconds for v in eng._pf_chunks.values())
    disp = _dispatch_profile(eng)
    say("main", model="deepseek-7b", params_gb=f"{n_bytes / 1e9:.2f}",
        init_s=f"{t_init:.2f}", engine_build_s=f"{t_engine:.2f}",
        pipeline_s=f"{pipeline_s:.3f}", requests=len(rids),
        generated=rep.generated_tokens, decode_dispatches=rep.steps,
        decode_tok_s=f"{rep.decode_tok_s:.2f}",
        ttft_p50_ms=f"{rep.ttft_p50_ms:.1f}",
        ttft_p95_ms=f"{rep.ttft_p95_ms:.1f}",
        p50_ms=f"{rep.p50_ms:.1f}", wall_s=f"{rep.wall_seconds:.2f}",
        prefill_s=f"{rep.prefill_seconds:.2f}",
        dispatch_host_ms=f"{disp['host_ms']:.1f}",
        dispatch_wall_ms=f"{disp['wall_ms']:.1f}",
        dispatch_device_busy_ms=disp["busy_ms"],
        shared_attaches=rep.pool.shared_attaches,
        cow_copies=rep.pool.cow_copies,
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps({k: v["launches"] for k, v in counts.items()}))
    say("profile", dispatch="decode chunk (4 steps x 30 layers)",
        device_kernels=disp["n_kernels"], top=json.dumps(disp["top"]))
    del eng, params
    torch.cuda.empty_cache()


# -- 5. port on the card vs port on the CPU -----------------------------------------
def phase_parity() -> None:
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    from repro_torch.models.lm import build_dense_chunk

    base = dataclasses.replace(get_config("deepseek-7b").reduced(),
                               d_model=128, d_head=64, d_ff=256)
    line = {}
    for dtype in ("f32", "bf16"):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        ecfg = dict(mode="paged", slots=SLOTS, max_len=64, page_size=8,
                    chunk_steps=4)
        params = build_dense_chunk(cfg, 64, SLOTS, 4,
                                   page_size=8).builder.init_params(0)
        prompts = _prompts(cfg.vocab, (5, 19, 27, 12, 40), 16, seed=1)
        results = {}
        for dev in ("cuda", "cpu"):
            kernels.reset_counters()
            eng = ServeEngine(cfg, EngineConfig(device=dev, params=params,
                                                **ecfg),
                              options=CompileOptions(level="O2",
                                                     use_pallas=True))
            rids = [eng.submit(p, 10) for p in prompts]
            rep = eng.run()
            require(all(rep.statuses[r] == "completed" for r in rids),
                    f"{dev} {dtype}: {rep.statuses}")
            require(eng.pool.verify() == [] and rep.pool.pages_in_use == 0,
                    f"{dev} {dtype}: pool not drained")
            results[dev] = np.stack([rep.results[r] for r in rids])
            if dev == "cuda":
                launched = sum(c["launches"]
                               for c in kernels.counters().values())
                require(launched > 0, f"{dtype}: no kernel launched on CUDA")
        agree = float((results["cuda"] == results["cpu"]).mean())
        line[f"{dtype}_token_agreement"] = f"{agree:.4f}"
        line[f"{dtype}_cuda_launches"] = launched
        if dtype == "f32":
            # f32 logits leave no near-ties for the two summation orders
            # to split: the greedy tokens must be identical
            require(agree == 1.0, f"f32 greedy tokens differ: cuda "
                    f"{results['cuda'].tolist()} cpu "
                    f"{results['cpu'].tolist()}")
    say("parity", model="deepseek-7b reduced d_model=128 d_head=64 d_ff=256",
        **line)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    if "--kernels-only" in sys.argv[1:]:
        return 0    # a first check of new kernels: no result line
    phase_main(report)
    phase_parity()
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
