"""Chip smoke test of the torch port on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --kernels-only   # phases 1-3, no result line

Phases, one line each; any failure raises and the script exits non-zero
without printing a result:

  1. device   -- the card's name and power limit (nvidia-smi) and torch's
                 name for it;
  2. build    -- nvcc builds the five Hopper kernels from
                 src/repro_torch/kernels/csrc/ (sm_90a) at first use, one
                 process per source, all started together;
  3. kernels  -- each kernel against its plain PyTorch version at the
                 full-width deepseek-7b shapes of the serving paths
                 (bf16, plus one f32 case each), with its time, the plain
                 version's, a one-call PyTorch yardstick's where there is
                 one, and the card's bound for the same work; then the
                 determinism checks: two launches on the same inputs give
                 the same bits, and a probe row gives the same bits alone
                 and inside batches of 4, 64 and 512 rows (matmul,
                 rmsnorm, norm_matmul, swiglu); swiglu called on two
                 inputs in turn gives each its own bits; for flash attention
                 two launches, a probe (slot, head) alone and inside 4
                 slots, and decode at position p against row p of the
                 dense prefill, for p in 0, 63, 64, 127;
  4. main     -- ServeEngine(mode="paged") at O2 with the kernels on
                 full-width deepseek-7b (30 layers, d_model 4096, vocab
                 102400, f32 params drawn on the card from a seed):
                 6 greedy requests, two sharing a 32-token prefix, run to
                 drain; the four kernels of this path (its chunked prefill
                 holds no Attention op) must have launched;
  5. flash    -- the same model and weights through
                 ServeEngine(mode="donated"): 4 greedy requests of 128
                 prompt tokens and 16 new ones, one dense prefill and one
                 fused 15-step chunk, so flash attention launches once per
                 layer and step (480 times); then the paged engine with a
                 dense prefill (prefill_chunk=0) on 2 requests, whose
                 prefills launch it too.  All five kernels must launch;
  6. parity   -- reduced deepseek-7b with the same numpy weights and
                 prompts through the port on the card (kernels) and on the
                 CPU (plain versions): paged at d_head 64, and lockstep,
                 donated, continuous and paged with a dense prefill at
                 d_head 128 (flash attention on the card); f32 greedy
                 tokens must be identical.

In phases 4 and 5 no kernel may have been refused.  Phase 6 counts its
refusals but does not gate them: the reduced vocabulary (257) is no
whole number of 16-byte vectors, so the unembed takes the plain version
there, as the reference's fallback rule says.  Then one JSON line with
every kernel's numbers, the card's name and power limit, and the result
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# a kernel's max |kernel - plain| over the scale max(max |plain|, 1):
# 16-bit, two units in the last place at the scale (a kernel whose f32
# sum differs from the plain version's only in order rounds at most one
# unit apart); f32, 1e-4
TOL = {torch.bfloat16: 2 * 2.0 ** -7, torch.float16: 2 * 2.0 ** -10,
       torch.float32: 1e-4}
D, F, V, SLOTS, CHUNK, DH, HEADS = 4096, 11008, 102400, 4, 64, 128, 32
DENSE = 512   # rows of the donated dense prefill (4 prompts x 128)
REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:20",
    "norm_matmul": "src/repro/kernels/norm_matmul.py:21",
    "swiglu": "src/repro/kernels/swiglu.py:22",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:18",
    "flash_attention": "src/repro/kernels/flash_attention.py:41",
}
# the kernels each serving path must launch: the paged path's chunked
# prefill attends through an IR composition, every other path holds an
# Attention op at d_head 128
PAGED_KERNELS = ("matmul", "norm_matmul", "swiglu", "rmsnorm")
ALL_KERNELS = PAGED_KERNELS + ("flash_attention",)


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
    serving path, where each layer's weights are new.  The write keeps
    the card busy (~0.15 ms) while the host enqueues the launch, so the
    events time the device's work, not the wrapper's Python."""
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
    at the shapes the serving paths give each kernel: decode (4 slots)
    first -- the case the result line reports -- then prefill (a 64-row
    chunk, or a dense prefill for attention) and the f32 case.  Bytes
    count each input read once and the output written once (for
    attention, the K/V rows the causal mask lets some query see); flops
    count what this case's inputs need."""
    from repro_torch.kernels import matmul as km, norm_matmul as kn
    from repro_torch.kernels import rmsnorm as kr, swiglu as ks
    from repro_torch.kernels import flash_attention as kf
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
    mm("dense prefill (512x4096)@(4096x4096)", DENSE, D, D, bf)
    mm("f32 (4x4096)@(4096x4096)", SLOTS, D, D, f32)
    nm("decode qkv (4x4096)(4096x4096)", SLOTS, D, bf)
    nm("decode final+unembed (4x4096)(4096x102400) g f32", SLOTS, V, f32)
    nm("prefill qkv (64x4096)(4096x4096)", CHUNK, D, bf)
    nm("dense prefill qkv (512x4096)(4096x4096)", DENSE, D, bf)
    sw("decode (4x4096) F=11008", SLOTS, bf)
    sw("prefill (64x4096) F=11008", CHUNK, bf)
    sw("dense prefill (512x4096) F=11008", DENSE, bf)
    sw("f32 decode (4x4096) F=11008", SLOTS, f32)
    def fa(label, B, Hq, Hkv, Sq, Skv, off, dt):
        q = _rand((B, Hq, Sq, DH), dt, gen)
        k = _rand((B, Hkv, Skv, DH), dt, gen)
        v = _rand((B, Hkv, Skv, DH), dt, gen)
        o = None if off is None else torch.tensor(off, dtype=torch.int32,
                                                  device="cuda")
        # causal on absolute positions: what this case's mask lets through
        vis = (torch.arange(Skv, device="cuda")[None, :]
               <= torch.arange(Sq, device="cuda")[:, None] + (off or 0))
        pairs = int(vis.sum())
        rows = int(vis.any(0).sum())   # K/V rows some query sees
        s = q.element_size()
        # the one-call yardstick: SDPA over repeated kv heads (repeated
        # here, outside the timed call), is_causal where top-left
        # alignment is the mask, else the boolean mask
        kr_, vr_ = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
        if off is None:
            lib = lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                q, kr_, vr_, is_causal=True)
        else:
            lib = lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                q, kr_, vr_, attn_mask=vis)
        cases.append(("flash_attention", label,
                      lambda: kf.flash_attention(q, k, v, q_offset=o),
                      lambda: ref.flash_attention_ref(q, k, v, q_offset=o),
                      lib, (2 * B * Hq * Sq * DH + 2 * B * Hkv * rows * DH) * s,
                      4 * B * Hq * pairs * DH, dt))

    rn("decode pre-MLP (4x4096)", SLOTS, bf)
    rn("prefill final (64x4096) w f32", CHUNK, f32)
    rn("dense prefill (512x4096)", DENSE, bf)
    fa("decode (4x32x1) over 256 keys at pos 255", SLOTS, HEADS, HEADS, 1,
       256, 255, bf)
    fa("decode (4x32x1) over 256 keys at pos 63", SLOTS, HEADS, HEADS, 1,
       256, 63, bf)
    fa("dense prefill (4x32x128) causal", SLOTS, HEADS, HEADS, 128, 128,
       None, bf)
    fa("paged-dense prefill (1x32x100) causal", 1, HEADS, HEADS, 100, 100,
       None, bf)
    fa("f32 decode (4x32x1) at pos 255", SLOTS, HEADS, HEADS, 1, 256, 255,
       f32)
    fa("GQA decode Hq 64 Hkv 8 (qwen1.5-110b) at pos 255", SLOTS, 64, 8, 1,
       256, 255, bf)
    # more (slot, kv head) pairs than SMs: 512 decode blocks
    fa("decode (16x32x1) over 256 keys at pos 255", 16, HEADS, HEADS, 1, 256,
       255, bf)
    return cases


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
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
                "library_ms": lib_ms, "launches_by_phase": {}}
    del flush
    torch.cuda.empty_cache()
    check_determinism(gen)
    return report


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def check_determinism(gen) -> None:
    """The determinism the serving contracts rest on (chunked == dense
    prefill, batched == alone): two launches on the same inputs give the
    same bits, and a fixed probe row gives the same bits in batches of
    every size the serving paths use, at a different position in each."""
    from repro_torch.kernels import matmul as km, rmsnorm as kr
    from repro_torch.kernels import norm_matmul as kn, swiglu as ks
    bf, f32 = torch.bfloat16, torch.float32

    def probe_rows(kernel, label, sizes, run, make):
        probe = make(1)
        rows = {}
        for m, pos in sizes.items():
            batch = make(m)
            batch[pos] = probe[0]
            out = run(batch)
            require(_bitwise(out, run(batch)),
                    f"{kernel} {label}: two launches at {m} rows differ")
            rows[m] = out[pos:pos + 1]
        first = rows[min(rows)]
        for m, r in rows.items():
            require(_bitwise(r, first), f"{kernel} {label}: the probe row "
                    f"at {m} rows differs from it alone: max |diff| "
                    f"{float((r.double() - first.double()).abs().max())}")
        say("determinism", kernel=kernel, dtype=label, runs="bitwise",
            rows=",".join(map(str, sizes)),
            positions=",".join(map(str, sizes.values())), probe="bitwise")

    def name(dt):
        return str(dt).split(".")[-1]

    for dt in (bf, f32):
        b = _rand((D, D), dt, gen, D ** -0.5)
        probe_rows("matmul", name(dt),
                   {1: 0, SLOTS: 2, CHUNK: 45, DENSE: 300},
                   lambda a: km.matmul(a, b),
                   lambda m: _rand((m, D), dt, gen))
    for dt, w_dt in ((bf, bf), (bf, f32), (f32, f32)):
        w = (1 + 0.1 * _rand((D,), f32, gen)).to(w_dt)
        probe_rows("rmsnorm", f"{name(dt)}/w {name(w_dt)}",
                   {1: 0, SLOTS: 3, CHUNK: 17, DENSE: 400},
                   lambda x: kr.rmsnorm(x, w, 1e-6),
                   lambda m: _rand((m, D), dt, gen))
    w = _rand((D, D), bf, gen, D ** -0.5)
    for g_dt in (bf, f32):
        g = (1 + 0.1 * _rand((D,), f32, gen)).to(g_dt)
        probe_rows("norm_matmul", f"bfloat16/g {name(g_dt)}",
                   {1: 0, SLOTS: 1, CHUNK: 33, DENSE: 200},
                   lambda x: kn.norm_matmul(x, g, w, 1e-6),
                   lambda m: _rand((m, D), bf, gen))
    for dt in (bf, f32):
        wg = _rand((D, F), dt, gen, D ** -0.5)
        wu = _rand((D, F), dt, gen, D ** -0.5)
        wd = _rand((F, D), dt, gen, F ** -0.5)
        probe_rows("swiglu", name(dt),
                   {1: 0, SLOTS: 2, CHUNK: 45, DENSE: 300},
                   lambda x: ks.swiglu(x, wg, wu, wd),
                   lambda m: _rand((m, D), dt, gen))
        check_swiglu_alternation(name(dt), wg, wu, wd, gen)
    check_flash_determinism(gen)


def check_swiglu_alternation(label, wg, wu, wd, gen) -> None:
    """swiglu's down launch must read h only after the gate/up launch has
    written all of it (griddepcontrol.wait): called on two inputs in turn,
    each call gives the bits of the first call on its input and stays
    within phase 3's limit of the plain version -- a copy of h issued
    early would read the other input's h, which the allocator tends to
    hand back at the same address."""
    from repro_torch.kernels import ref, swiglu as ks
    for m in (SLOTS, CHUNK):
        xs = [_rand((m, D), wg.dtype, gen) for _ in range(2)]
        firsts = [ks.swiglu(x, wg, wu, wd) for x in xs]
        for i, x in enumerate(xs):
            p = ref.swiglu_ref(x, wg, wu, wd).double()
            err = float((firsts[i].double() - p).abs().max())
            require(err <= TOL[wg.dtype] * max(float(p.abs().max()), 1.0),
                    f"swiglu {label} alternation at {m} rows: input {i} "
                    f"off its plain version by {err}")
        require(not _bitwise(firsts[0], firsts[1]),
                f"swiglu {label}: two inputs gave the same bits")
        for i in range(6):
            out = ks.swiglu(xs[i % 2], wg, wu, wd)
            require(_bitwise(out, firsts[i % 2]),
                    f"swiglu {label} alternation at {m} rows: call {i} "
                    f"differs from the first call on its input")
    say("determinism", kernel="swiglu", dtype=label,
        alternating_inputs="bitwise", rows=f"{SLOTS},{CHUNK}")


def check_flash_determinism(gen) -> None:
    """Flash attention (bf16, deepseek-7b's heads): two launches give the
    same bits; a probe (slot, head) gives the same bits alone and inside
    4 slots; decode at position p gives row p of the causal dense prefill
    bit for bit (a row's reduction order depends only on the keys it can
    see, never on the query tile or the batch)."""
    from repro_torch.kernels import flash_attention as kf
    P = 128
    q, k, v = (_rand((SLOTS, HEADS, P, DH), torch.bfloat16, gen)
               for _ in range(3))
    full = kf.flash_attention(q, k, v, causal=True)
    require(_bitwise(full, kf.flash_attention(q, k, v, causal=True)),
            "flash_attention: two launches of the dense prefill differ")
    alone = kf.flash_attention(q[2:3, 7:8], k[2:3, 7:8], v[2:3, 7:8],
                               causal=True)
    require(_bitwise(alone, full[2:3, 7:8]), "flash_attention: slot 2 head "
            "7 alone differs from it inside 4 slots")
    for p in (0, 63, 64, 127):
        off = torch.tensor(p, dtype=torch.int32, device="cuda")
        one = kf.flash_attention(q[:, :, p:p + 1], k, v, causal=True,
                                 q_offset=off)
        require(_bitwise(one, kf.flash_attention(q[:, :, p:p + 1], k, v,
                                                 causal=True, q_offset=off)),
                f"flash_attention: two decode launches at {p} differ")
        row = full[:, :, p:p + 1]
        require(_bitwise(one, row), f"flash_attention: decode at {p} "
                f"differs from row {p} of the prefill: max |diff| "
                f"{float((one.double() - row.double()).abs().max())}")
    say("determinism", kernel="flash_attention", dtype="bfloat16",
        runs="bitwise", slot_alone_vs_batch="bitwise",
        decode_vs_prefill_rows="0,63,64,127", decode_vs_prefill="bitwise")


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
    the card waits on the host.  ``union_ms`` is the time at least one
    kernel ran (their intervals merged): the sum books a programmatic
    dependent's blocks that wait at griddepcontrol.wait while the kernel
    before it finishes (norm_matmul's GEMM, swiglu's down product) as
    busy, and two overlapping kernels twice."""
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
    from torch.autograd import DeviceType
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA
                   and ev.time_range.end > ev.time_range.start)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    # the port's kernels by name (norm_matmul before matmul: a substring)
    ours = {}
    for ms, n, key in rows:
        for name in ("norm_matmul", "matmul", "swiglu", "rmsnorm", "flash"):
            if name in key:
                t = ours.setdefault(name, [0.0, 0])
                t[0] += ms
                t[1] += n
                break
    return {"host_ms": (h1 - h0) * 1e3, "wall_ms": (h2 - h0) * 1e3,
            "busy_ms": f"{busy:.1f}" if rows else "not measured",
            "union_ms": f"{union / 1e3:.1f}" if spans else "not measured",
            "n_kernels": sum(r[1] for r in rows),
            "ours": {k: [round(v[0], 3), v[1]] for k, v in ours.items()},
            "top": [[k[:48], round(ms, 3), n] for ms, n, k in rows[:8]]}


def _record_launches(report: dict, phase: str, counts: dict,
                     required) -> None:
    """Gate one main-path run's counts (set to 0 just before it): every
    kernel the path runs launched, none refused; and add them to the
    report."""
    for name, c in counts.items():
        require(c["rejected"] == 0,
                f"{phase}: {name}: {c['rejected']} refusals")
        if name in required:
            require(c["launches"] > 0,
                    f"{phase}: {name}: no launch on this path")
        report[name]["launches"] += c["launches"]
        report[name]["launches_by_phase"][phase] = c["launches"]


def phase_main(report: dict):
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
    _record_launches(report, "main", counts, PAGED_KERNELS)
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
        dispatch_device_union_ms=disp["union_ms"],
        shared_attaches=rep.pool.shared_attaches,
        cow_copies=rep.pool.cow_copies,
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps({k: v["launches"] for k, v in counts.items()}))
    say("profile", dispatch="decode chunk (4 steps x 30 layers)",
        device_kernels=disp["n_kernels"],
        port_kernels_ms_launches=json.dumps(disp["ours"]),
        top=json.dumps(disp["top"]))
    del eng
    torch.cuda.empty_cache()
    return cfg, params


# -- 5. the flash-attention path, full width --------------------------------
def phase_flash(report: dict, cfg, params) -> None:
    """Donated decode of full-width deepseek-7b on phase 4's weights (the
    engines map parameters by name), then the paged engine's dense
    prefill.  Flash attention runs in every dense prefill (one launch
    per layer) and in every step of the fused decode chunk."""
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.launch.engine import EngineConfig, ServeEngine

    opts = CompileOptions(level="O2", use_pallas=True)
    P, G, L = 128, 16, cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, EngineConfig(mode="donated", slots=SLOTS,
                                        max_len=256, device="cuda",
                                        params=params), options=opts)
    t_engine = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, P).astype(np.int32)
               for _ in range(SLOTS)]
    kernels.reset_counters()
    rids = [eng.submit(p, G) for p in prompts]
    rep = eng.run()
    torch.cuda.synchronize()
    counts = kernels.counters()
    require(all(rep.statuses[r] == "completed" for r in rids),
            f"donated: statuses {rep.statuses} {rep.errors}")
    for r in rids:
        toks = rep.results[r]
        require(len(toks) == G and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab, f"donated {r}: {toks}")
    # one dense prefill (B 4) plus G - 1 fused decode steps, each layer
    expect = L * (1 + (G - 1))
    got = counts["flash_attention"]["launches"]
    require(got == expect, f"donated: {got} flash launches, {expect} "
            f"expected (a prefill and {G - 1} steps x {L} layers)")
    _record_launches(report, "flash_donated", counts, ALL_KERNELS)
    say("flash", path="donated", model="deepseek-7b", requests=len(rids),
        prompt_len=P, generated=rep.generated_tokens,
        engine_build_s=f"{t_engine:.2f}",
        decode_tok_s=f"{rep.decode_tok_s:.2f}",
        ttft_p50_ms=f"{rep.ttft_p50_ms:.1f}",
        chunk_ms=f"{rep.p50_ms:.1f}", wall_s=f"{rep.wall_seconds:.2f}",
        prefill_s=f"{rep.prefill_seconds:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=json.dumps({k: v["launches"] for k, v in counts.items()}))
    del eng
    torch.cuda.empty_cache()

    # the repaired path: the paged engine with a dense prefill
    eng = ServeEngine(cfg, EngineConfig(
        mode="paged", slots=SLOTS, max_len=256, page_size=16, chunk_steps=4,
        prefill_chunk=0, device="cuda", params=params), options=opts)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (100, 37)]
    kernels.reset_counters()
    rids = [eng.submit(p, 8) for p in prompts]
    rep = eng.run()
    torch.cuda.synchronize()
    counts = kernels.counters()
    require(all(rep.statuses[r] == "completed" for r in rids),
            f"paged dense prefill: statuses {rep.statuses} {rep.errors}")
    require(all(len(rep.results[r]) == 8 for r in rids),
            f"paged dense prefill: {rep.results}")
    require(rep.pool.pages_in_use == 0 and eng.pool.verify() == [],
            "paged dense prefill: pool not drained")
    got = counts["flash_attention"]["launches"]
    require(got == L * len(rids), f"paged dense prefill: {got} flash "
            f"launches, {L * len(rids)} expected (one per layer and prompt)")
    _record_launches(report, "flash_paged_dense", counts, ALL_KERNELS)
    say("flash", path="paged prefill_chunk=0", requests=len(rids),
        prompt_lens="100,37", generated=rep.generated_tokens,
        ttft_p50_ms=f"{rep.ttft_p50_ms:.1f}",
        decode_tok_s=f"{rep.decode_tok_s:.2f}",
        launches=json.dumps({k: v["launches"] for k, v in counts.items()}))
    del eng
    torch.cuda.empty_cache()


# -- 6. port on the card vs port on the CPU ----------------------------------
def _serve_both(cfg, params, ecfg, prompts, max_new):
    """The same engine config, weights and prompts on the card and on the
    CPU; returns ({device: tokens (requests, max_new)}, card counters)."""
    from repro_torch import kernels
    from repro_torch.backend import CompileOptions
    from repro_torch.launch.engine import EngineConfig, ServeEngine

    results, card = {}, None
    for dev in ("cuda", "cpu"):
        kernels.reset_counters()
        eng = ServeEngine(cfg, EngineConfig(device=dev, params=params,
                                            **ecfg),
                          options=CompileOptions(level="O2",
                                                 use_pallas=True))
        rids = [eng.submit(p, max_new) for p in prompts]
        rep = eng.run()
        mode = ecfg["mode"]
        require(all(rep.statuses[r] == "completed" for r in rids),
                f"{mode} {dev}: {rep.statuses} {rep.errors}")
        if eng.pool is not None:
            require(eng.pool.verify() == [] and rep.pool.active == 0,
                    f"{mode} {dev}: pool not drained")
        results[dev] = np.stack([rep.results[r] for r in rids])
        if dev == "cuda":
            card = kernels.counters()
    return results, card


def _ulp(x: float, dtype: torch.dtype) -> float:
    """One unit in the last place of a value of magnitude ``|x|`` in
    ``dtype`` (normal range)."""
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    return 2.0 ** (math.floor(math.log2(max(abs(float(x)), 2.0 ** -14)))
                   - mant)


@contextlib.contextmanager
def _kernels_held_to_plain(readings: dict):
    """While open, every kernel wrapper also runs its plain version on the
    same card inputs and records in ``readings[kernel]`` the largest
    |kernel - plain| in units in the last place of the output's scale
    (max |plain|).  The kernel's output is what the caller gets."""
    from repro_torch.kernels import MODULES, ref
    plain = {"matmul": ref.matmul_ref, "norm_matmul": ref.norm_matmul_ref,
             "swiglu": ref.swiglu_ref, "rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.flash_attention_ref}
    saved = {name: getattr(mod, name) for name, mod in MODULES.items()}

    def held(name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            p = plain[name](*args, **kw).double()
            err = float((out.double() - p).abs().max())
            ulps = err / _ulp(float(p.abs().max()), out.dtype)
            readings[name] = max(readings.get(name, 0.0), ulps)
            return out
        return run

    for name, mod in MODULES.items():
        setattr(mod, name, held(name, saved[name]))
    try:
        yield
    finally:
        for name, mod in MODULES.items():
            setattr(mod, name, saved[name])


def _prefill_logits(cfg, params, dev: str, tokens) -> np.ndarray:
    """The next-token logits after ``tokens`` from the dense (1, P) prefill
    graph at O2 with the kernels on ``dev`` -- the graph continuous and
    paged-dense serving admit a request with -- as f32."""
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs
    P = len(tokens)
    g = build_graphs(cfg, ShapeConfig("prefill", "prefill", P, 1), 1)
    cf = Backend.create("torch", device=dev).compile(
        g.fn, CompileOptions(level="O2", use_pallas=True))
    outs = cf(np.asarray(tokens, np.int32).reshape(1, P),
              *[params[n] for n in g.builder.param_names()])
    return np.asarray(outs[0], np.float32).reshape(-1)


def _divergence_witness(cfg, params, prompts, results) -> list:
    """For each request whose card tokens differ from the CPU's: the first
    step that differs, and that step's logits from a dense prefill of the
    prompt plus the tokens both devices agree on -- the CPU's top two and
    their gap in bf16 units in the last place, the card's logits for the
    same two -- with every kernel of the card's prefill held against its
    plain version on the same inputs (in units in the last place of its
    output's scale)."""
    found = []
    for r, (card_t, cpu_t) in enumerate(zip(results["cuda"],
                                            results["cpu"])):
        differ = np.nonzero(card_t != cpu_t)[0]
        if not len(differ):
            continue
        j = int(differ[0])
        seq = np.concatenate([prompts[r], cpu_t[:j]])
        cpu = _prefill_logits(cfg, params, "cpu", seq)
        readings = {}
        with _kernels_held_to_plain(readings):
            card = _prefill_logits(cfg, params, "cuda", seq)
        a, b = (int(t) for t in np.argsort(-cpu, kind="stable")[:2])
        found.append({
            "request": r, "prompt_len": len(prompts[r]), "step": j,
            "card_token": int(card_t[j]), "cpu_token": int(cpu_t[j]),
            "cpu_top2": [a, b],
            "cpu_top2_logits": [float(cpu[a]), float(cpu[b])],
            "cpu_gap_ulps": float(cpu[a] - cpu[b]) / _ulp(cpu[a],
                                                          torch.bfloat16),
            "card_logits_at_cpu_top2": [float(card[a]), float(card[b])],
            "card_pick": int(np.argmax(card)),
            "kernel_vs_plain_ulps": {k: round(v, 3)
                                     for k, v in readings.items()}})
    return found


def phase_parity() -> None:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs

    base = get_config("deepseek-7b").reduced()
    line = {}
    # (label, widths, modes): d_head 64 keeps the composed attention, d_head
    # 128 takes flash attention wherever the graph holds an Attention op
    configs = [("dh64", dict(d_model=128, d_head=64, d_ff=256), ("paged",)),
               ("dh128", dict(d_model=256, n_heads=2, n_kv_heads=2,
                              d_head=128, d_ff=256),
                ("lockstep", "donated", "continuous", "paged_dense"))]
    for label, widths, modes in configs:
        for dtype in ("f32", "bf16"):
            cfg = dataclasses.replace(base, compute_dtype=dtype, **widths)
            params = build_graphs(cfg, ShapeConfig("decode", "decode", 64,
                                                   SLOTS),
                                  SLOTS).builder.init_params(0)
            for mode in modes:
                ecfg = dict(mode=mode, slots=SLOTS, max_len=64)
                if mode == "paged":
                    ecfg.update(page_size=8, chunk_steps=4)
                    prompts = _prompts(cfg.vocab, (5, 19, 27, 12, 40), 16,
                                       seed=1)
                elif mode == "paged_dense":
                    ecfg.update(mode="paged", page_size=8, chunk_steps=4,
                                prefill_chunk=0)
                    prompts = _prompts(cfg.vocab, (5, 19, 27, 12, 40), 16,
                                       seed=1)
                elif mode == "continuous":
                    prompts = _prompts(cfg.vocab, (5, 19, 27, 12, 40), 16,
                                       seed=1)
                else:   # lockstep, donated: one batch of uniform prompts
                    prompts = _prompts(cfg.vocab, (24,) * SLOTS, 8, seed=1)
                results, card = _serve_both(cfg, params, ecfg, prompts, 10)
                launched = {k: c["launches"] for k, c in card.items()}
                require(sum(launched.values()) > 0,
                        f"{label} {mode} {dtype}: no kernel on the card")
                if label == "dh128":
                    require(launched["flash_attention"] > 0,
                            f"{mode} {dtype}: no flash launch on the card")
                agree = float((results["cuda"] == results["cpu"]).mean())
                key = f"{label}_{mode}_{dtype}"
                line[f"{key}_agreement"] = f"{agree:.4f}"
                line[f"{key}_flash"] = launched["flash_attention"]
                line[f"{key}_refused"] = sum(c["rejected"]
                                             for c in card.values())
                if dtype == "f32":
                    # f32 logits leave no near-ties for the two summation
                    # orders to split: the greedy tokens must be identical
                    require(agree == 1.0, f"{key}: greedy tokens differ: "
                            f"cuda {results['cuda'].tolist()} cpu "
                            f"{results['cpu'].tolist()}")
                elif agree < 1.0:
                    # a bf16 divergence must be a near-tie the kernels'
                    # rounding split, not a kernel off its plain version
                    found = _divergence_witness(cfg, params, prompts,
                                                results)
                    say("parity-witness", case=key,
                        divergent=json.dumps(found))
                    for w in found:
                        worst = max(w["kernel_vs_plain_ulps"].values(),
                                    default=0.0)
                        require(w["cpu_gap_ulps"] <= 2 and worst <= 2,
                                f"{key}: request {w['request']} diverges "
                                f"at step {w['step']} without a near-tie: "
                                f"{w}")
    say("parity", models="deepseek-7b reduced d_head 64 (d_model 128) and "
        "d_head 128 (d_model 256, 2 heads)", **line)


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
    cfg, params = phase_main(report)
    phase_flash(report, cfg, params)
    del params
    torch.cuda.empty_cache()
    phase_parity()
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
