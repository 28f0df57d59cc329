"""Output bits of the fixed-order batched matmul, and of the 16-bit routes
of matmul, swiglu and norm_matmul, at fixed lists of shapes, as sha256
digests, so that two checkouts can be shown to give the same bits on the
card; with ``--time``, the kernels' times at phase 3's shapes, so that
one call on one card compares two checkouts' kernels.  Kernels come from
``repro_torch.kernels`` of the tree ``--src`` names (the parent unpacked
into a git-ignored directory):

    python scripts/torch_bmm_bits.py --src build/parent/src --time --json results/p1.json
    python scripts/torch_bmm_bits.py --time --json results/c1.json
    python scripts/torch_bmm_bits.py --time --json results/c2.json
    python scripts/torch_bmm_bits.py --src build/parent/src --time --json results/p2.json
    python scripts/torch_bmm_bits.py --compare results/p1.json results/c1.json

The batched kernel's operands are drawn from ``--seed`` with numpy (a
pool of normal values, repeated on the card to the size each operand
needs), each a fresh (16-byte aligned) tensor, as the emitter hands them
over; the grid's shapes at M 5 and 128 run again from operands at an odd
element offset, which the kernels copy element by element.  matmul's and
swiglu's operands are drawn on the card from ``--seed``.  A time is
``chip_smoke.py``'s phase 3 measure: the median of 20 launches, each
timed with CUDA events after a 512 MB write that flushes L2 and keeps
the card busy while the host enqueues; the timed shapes are the batched
kernel's named ones, the f32 routes of matmul, swiglu and norm_matmul
(whose f32 bits are not digested: an order may change them by design),
matmul's 16-bit shapes, and the 16-bit shapes of swiglu and norm_matmul
(FUSED_16_TIMES), each beside matmul's time on the same product(s) in
the same process and its bound (each input read once, the output written
once, or the operations at the tensor cores' 989 TFLOP/s, whichever is
longer).
``--compare`` prints each timed shape side by side and exits 1 when a
digest differs or a shape is missing; with ``--f32-may-move K0`` an f32
digest of a contraction longer than K0 may differ (a change of the f32
order moves them by design: ``--f32-may-move 32`` for sub-chains of 32,
which leave a K <= 32 sum one chain as before), every 16-bit digest and
every other f32 digest must not.  Needs a card; the compare needs none.

    python scripts/torch_bmm_bits.py --compare results/p1.json results/c1.json --f32-may-move 32
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

# the named shapes: phase 3's cases of chip_smoke.py (batch, M, N, K,
# type, A as (K, M), B as (N, K), out type)
NAMED = (
    ("paged decode q.k^T", 128, 1, 256, 128, "f32", False, True, "f32"),
    ("paged decode p.V", 128, 1, 128, 256, "f32", False, False, "f32"),
    ("prefill chunk q.k^T", 32, 64, 256, 128, "f32", False, True, "f32"),
    ("prefill chunk p.V bf16", 32, 64, 128, 256, "bf16", False, False,
     "bf16"),
    ("sampler pick", 4, 1, 1, 102400, "f32", False, False, "f32"),
    ("paged write one-hot", 1, 1040, 4096, 4, "bf16", True, False, "bf16"),
    ("train dX", 1, 2048, 4096, 4096, "bf16", False, True, "bf16"),
    ("train dW", 1, 4096, 11008, 2048, "bf16", True, False, "bf16"),
    ("train attention scores f32", 128, 512, 512, 128, "f32", False, True,
     "f32"),
    ("xlstm sLSTM backward", 4, 4, 256, 1024, "f32", False, False, "f32"),
    ("moe expert FFN up (deepseek-v3)", 256, 8, 2048, 7168, "bf16", False,
     False, "bf16"),
    ("moe expert FFN down (deepseek-v3)", 256, 8, 7168, 2048, "bf16", False,
     False, "bf16"),
    # rows of C in no whole 16 bytes (the wgmma mainloop's register
    # epilogue), in both output types
    ("scores over 101 keys bf16", 3, 200, 101, 128, "bf16", False, True,
     "bf16"),
    ("scores over 101 keys f32 out", 3, 200, 101, 128, "bf16", False, True,
     "f32"),
    # mixtral's experts at its 4,224-token prefill (phase 9's launched
    # shapes): 8 experts' 1,320 rows against 201 MB of weights each
    ("mixtral experts up (8x1320x6144)@(8x6144x16384)", 8, 1320, 16384,
     6144, "bf16", False, False, "bf16"),
    ("mixtral experts down (8x1320x16384)@(8x16384x6144)", 8, 1320, 6144,
     16384, "bf16", False, False, "bf16"),
) + tuple(
    # matmul's products as one batch: the batched kernel's training tile
    # (the wgmma route above 64 rows) beside matmul's route at the same
    # rows (MATMUL_16_TIMES), which sets matmul's threshold
    (f"one batch ({m}x4096)@(4096x{n})", 1, m, n, 4096, "bf16", False,
     False, "bf16") for m in (128, 256) for n in (4096, 11008))
# the grid: every M and K below, both orientations of each operand, in
# f32 and bf16 (f32 out: the sums themselves), batch 2, N 72
GRID_M = (1, 5, 64, 65, 128, 2048)
GRID_K = (1, 4, 31, 32, 200, 256, 300, 1024, 4096, 5000)
GRID_N, GRID_BATCH = 72, 2
POOL = 4194301   # a prime: the repeated pool lines up with no tile


GRID_UNALIGNED_M = (5, 128)

D, F, V = 4096, 11008, 102400
# phase 3's f32 shapes of the other kernels, timed: (label, kernel,
# shape): matmul (M, K, N), swiglu (M, D, F, Do), norm_matmul (M, D, N)
KERNEL_TIMES = (
    ("matmul decode (4x4096)@(4096x4096)", "matmul", (4, D, D)),
    ("matmul one row (1x4096)@(4096x4096)", "matmul", (1, D, D)),
    ("matmul prefill (32x4096)@(4096x4096)", "matmul", (32, D, D)),
    ("matmul prefill (64x4096)@(4096x4096)", "matmul", (64, D, D)),
    ("matmul prefill (128x4096)@(4096x4096)", "matmul", (128, D, D)),
    ("matmul unembed (1x4096)@(4096x102400)", "matmul", (1, D, V)),
    ("matmul router (4x6144)@(6144x8) mixtral", "matmul", (4, 6144, 8)),
    ("matmul router (512x6144)@(6144x8) mixtral", "matmul", (512, 6144, 8)),
    ("matmul router (4224x6144)@(6144x8) mixtral", "matmul",
     (4224, 6144, 8)),
    ("matmul router (4x7168)@(7168x256) deepseek-v3", "matmul",
     (4, 7168, 256)),
    ("matmul router (256x7168)@(7168x256) deepseek-v3", "matmul",
     (256, 7168, 256)),
    ("swiglu decode (4x4096) F=11008", "swiglu", (4, D, F, D)),
    ("swiglu prefill (32x4096) F=11008", "swiglu", (32, D, F, D)),
    ("swiglu prefill (64x4096) F=11008", "swiglu", (64, D, F, D)),
    ("swiglu prefill (128x4096) F=11008", "swiglu", (128, D, F, D)),
    ("norm_matmul decode (4x4096)(4096x4096)", "norm_matmul", (4, D, D)),
    ("norm_matmul prefill (32x4096)(4096x4096)", "norm_matmul", (32, D, D)),
    ("norm_matmul prefill (64x4096)(4096x4096)", "norm_matmul", (64, D, D)),
    ("norm_matmul prefill (128x4096)(4096x4096)", "norm_matmul",
     (128, D, D)),
)
# matmul's 16-bit products, timed in bf16: the compute-bound shapes
# (mixtral's wo at its 4,224-token prefill, rg's 2,176-token product,
# phase 8's 2048-row q/k/v/o, a 512-row dense prefill), the rows on
# both sides of the wgmma route's threshold at N 4096, 6144 and 11008,
# and the serving rows (M <= 64), which keep their route
MATMUL_16_TIMES = tuple(
    [("matmul mixtral wo (4224x6144)@(6144x6144) bf16", (4224, 6144, 6144)),
     ("matmul rg (2176x4096)@(4096x4096) bf16", (2176, D, D)),
     ("matmul train q/k/v/o (2048x4096)@(4096x4096) bf16", (2048, D, D)),
     ("matmul dense prefill (512x4096)@(4096x4096) bf16", (512, D, D))]
    + [(f"matmul ({m}x4096)@(4096x{n}) bf16", (m, D, n))
       for m in (65, 96, 97, 128, 129, 160, 192, 224, 256, 384)
       for n in (4096, 6144, F)]
    + [(f"matmul ({m}x4096)@(4096x4096) bf16", (m, D, D))
       for m in (1, 4, 16, 64)]
    + [("matmul unembed (1x4096)@(4096x102400) bf16", (1, D, V))])
# swiglu's and norm_matmul's 16-bit shapes, timed in bf16 (label,
# kernel, shape: swiglu (M, D, F, Do), norm_matmul (M, D, N), its g in
# x's type but at the unembed, whose g is f32 as the final norm's): the
# wgmma route's rows (its fewest, 128, a dense prefill, phase 8's 2048,
# rg's 2,176, the train step's final norm + unembed), and the rows on
# both sides of its threshold at N (F) 4096, 6144 and 11008
FUSED_ROWS = (65, 96, 97, 128, 129, 160, 192, 224, 256, 384)
FUSED_16_TIMES = tuple(
    [(f"swiglu ({m}x4096) F=11008 bf16", "swiglu", (m, D, F, D))
     for m in (97, 128, 512, 2048, 2176)]
    + [(f"norm_matmul ({m}x4096)(4096x4096) bf16", "norm_matmul_gx",
        (m, D, D)) for m in (97, 128, 512, 2048, 2176)]
    + [("norm_matmul train final+unembed (2048x4096)(4096x102400) g f32 "
        "bf16", "norm_matmul", (2048, D, V))]
    + [(f"norm_matmul ({m}x4096)(4096x{n}) bf16", "norm_matmul_gx",
        (m, D, n)) for m in FUSED_ROWS for n in (6144, F)]
    + [(f"norm_matmul ({m}x4096)(4096x4096) bf16", "norm_matmul_gx",
        (m, D, D)) for m in FUSED_ROWS if m not in (97, 128)]
    + [(f"swiglu ({m}x4096) F={f} bf16", "swiglu", (m, D, f, D))
       for m in FUSED_ROWS for f in (4096, 6144)]
    + [(f"swiglu ({m}x4096) F=11008 bf16", "swiglu", (m, D, F, D))
       for m in FUSED_ROWS if m not in (97, 128)])
# the 16-bit routes of matmul, swiglu and norm_matmul (its g in x's type,
# "norm_matmul_gx", and in f32), digested in bf16 and f16: rows that take
# each tensor-core tile and each side of the wgmma route's threshold, at
# deepseek-7b's widths, at the compute-bound shapes and at ragged ones (K
# under one stage, K not in whole 16-byte vectors, N under one tile)
BITS_ROWS = (1, 4, 16, 17, 64, 65, 512)
KERNEL_BITS = tuple(
    [("matmul", (m, D, D)) for m in BITS_ROWS + (128, 129, 256, 2048)]
    + [("matmul", (1, D, V)), ("matmul", (5, 96, 24)),
       ("matmul", (65, 40, 8)), ("matmul", (3, 44, 16)),
       ("matmul", (4224, 6144, 6144)), ("matmul", (2176, D, D)),
       ("matmul", (300, 1000, 72)), ("matmul", (200, 44, 16)),
       ("matmul", (130, 40, 24))]
    + [("swiglu", (m, D, F, D)) for m in BITS_ROWS + (96, 97, 128, 2048,
                                                     2176)]
    + [("swiglu", (17, 1000, 200, 24)), ("swiglu", (3, 44, 40, 16)),
       ("swiglu", (130, 1000, 200, 24)), ("swiglu", (200, 44, 40, 16))]
    + [(k, (m, D, D)) for k in ("norm_matmul_gx", "norm_matmul")
       for m in BITS_ROWS + (96, 97, 128, 2048)]
    + [(k, (2048, D, V)) for k in ("norm_matmul_gx", "norm_matmul")]
    + [(k, (130, 1000, 72)) for k in ("norm_matmul_gx", "norm_matmul")]
    + [(k, (200, 44, 16)) for k in ("norm_matmul_gx", "norm_matmul")])


def shapes():
    """(label, (batch, M, N, K, type, A as (K, M), B as (N, K), out type),
    named, aligned) for every shape."""
    for name, *rest in NAMED:
        yield name, tuple(rest), True, True
    for aligned, ms in ((True, GRID_M), (False, GRID_UNALIGNED_M)):
        for dt in ("f32", "bf16"):
            for m in ms:
                for k in GRID_K:
                    for a_t in (False, True):
                        for b_t in (False, True):
                            yield (f"grid {dt} M{m} K{k} a_t={int(a_t)} "
                                   f"b_t={int(b_t)}"
                                   + ("" if aligned else " unaligned"),
                                   (GRID_BATCH, m, GRID_N, k, dt, a_t, b_t,
                                    "f32"), False, aligned)


def compare(a_path: str, b_path: str, f32_may_move=None) -> int:
    """Exit code of ``--compare``: 1 when a shape is missing from either
    file or a digest differs, except an f32 digest of a contraction over
    more than ``f32_may_move`` k (when given), which is counted as moved.
    Each digest's operand type and K come from the files' ``meta``."""
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    for label, ms in a["ms"].items():
        print(f"[bmm_bits] {label}: {ms:.4f} -> "
              f"{b['ms'].get(label, float('nan')):.4f} ms")
    meta = {**a.get("meta", {}), **b.get("meta", {})}
    a, b = a["digests"], b["digests"]
    bad, moved, same = [], [], 0
    for k in sorted(set(a) | set(b)):
        if a.get(k) == b.get(k):
            same += 1
            continue
        dt, kk = meta.get(k, ("?", 0))
        if (k in a and k in b and dt == "f32" and f32_may_move is not None
                and kk > f32_may_move):
            moved.append(k)
        else:
            bad.append(k)
    for k in bad:
        print(f"[bmm_bits] DIFFERS {k}: {a.get(k)} vs {b.get(k)}")
    f32_same = sum(1 for k in set(a) & set(b) if a[k] == b[k]
                   and meta.get(k, ("?", 0))[0] == "f32")
    print(f"[bmm_bits] compared {len(set(a) | set(b))} shapes: "
          f"{len(bad)} differ, {len(moved)} f32 moved (allowed above K "
          f"{f32_may_move}), {same} equal ({f32_same} of them f32)")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"),
        help="the tree's src directory (default: this checkout's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", help="write the digests (and times) here")
    ap.add_argument("--time", action="store_true",
                    help="also time the named shapes and KERNEL_TIMES")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    ap.add_argument("--f32-may-move", type=int, default=None, metavar="K0",
                    help="with --compare: f32 digests over K > K0 may move")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare, f32_may_move=args.f32_may_move)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("[bmm_bits] no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import batched_matmul as kb, matmul as km
    from repro_torch.kernels import norm_matmul as kn, swiglu as ks
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"[bmm_bits] src={os.path.abspath(args.src)} module={kb.__file__}"
          f" card={card!r}", flush=True)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    pool = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        POOL).astype(np.float32)).cuda()
    offset = [0]

    def draw(shape, dt, scale, aligned):
        # the pool's values from an offset that moves on (odd, so that an
        # unaligned draw starts off 16 bytes), repeated to the size needed
        n = int(np.prod(shape))
        off = offset[0] | 1
        reps = -(-(n + off) // POOL)
        x = (pool * scale).to(dt).repeat(reps)[off:off + n]
        offset[0] = (offset[0] + 7919) % POOL
        return (x.clone() if aligned else x).reshape(shape)

    def timed(fn, flush):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(20):
            flush.zero_()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)

    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    digests, times, meta = {}, {}, {}
    for label, (batch, m, n, k, dt, a_t, b_t, out), named, aligned in \
            shapes():
        t = dts[dt]
        a = draw((batch, k, m), t, 1.0, aligned).transpose(1, 2) if a_t \
            else draw((batch, m, k), t, 1.0, aligned)
        b = draw((batch, n, k), t, k ** -0.5, aligned).transpose(1, 2) \
            if b_t else draw((batch, k, n), t, k ** -0.5, aligned)
        o = kb.batched_matmul(a, b, dts[out])
        torch.cuda.synchronize()
        h = hashlib.sha256(o.contiguous().view(torch.uint8).cpu().numpy()
                           .tobytes()).hexdigest()
        digests[label] = h
        meta[label] = (dt, k)
        line = f"[bmm_bits] {label} sha256={h}"
        if named and args.time:
            times[label] = timed(lambda: kb.batched_matmul(a, b, dts[out]),
                                 flush)
            line += f" ms={times[label]:.4f}"
        print(line, flush=True)
        del a, b, o
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    def r(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    def call(kernel, shape, dt):
        if kernel == "matmul":
            m, k, n = shape
            a, b = r((m, k), dt), r((k, n), dt, k ** -0.5)
            return lambda: km.matmul(a, b)
        if kernel == "swiglu":
            m, d, f, do = shape
            x = r((m, d), dt)
            wg, wu = r((d, f), dt, d ** -0.5), r((d, f), dt, d ** -0.5)
            wd = r((f, do), dt, f ** -0.5)
            return lambda: ks.swiglu(x, wg, wu, wd)
        m, d, n = shape
        x, w = r((m, d), dt), r((d, n), dt, d ** -0.5)
        g = 1 + 0.1 * r((d,), torch.float32)
        if kernel == "norm_matmul_gx":   # g in x's type
            g = g.to(dt)
        return lambda: kn.norm_matmul(x, g, w, 1e-6)

    def matmul_route(kernel, shape, dt):
        # matmul's launches on the same product(s) (swiglu: x @ wg, x @
        # wu and h @ wd), and the kernel's bound
        s = torch.empty((), dtype=dt).element_size()
        if kernel == "swiglu":
            m, d, f, do = shape
            x, h = r((m, d), dt), r((m, f), dt)
            wg, wu = r((d, f), dt, d ** -0.5), r((d, f), dt, d ** -0.5)
            wd = r((f, do), dt, f ** -0.5)
            nbytes = (m * d + 2 * d * f + f * do + m * do) * s
            flops = 2 * m * d * f * 2 + 2 * m * f * do
            return (lambda: (km.matmul(x, wg), km.matmul(x, wu),
                             km.matmul(h, wd))), nbytes, flops
        m, d, n = shape
        x, w = r((m, d), dt), r((d, n), dt, d ** -0.5)
        g_size = 2 if kernel == "norm_matmul_gx" else 4
        return ((lambda: km.matmul(x, w)),
                (m * d + d * n + m * n) * s + d * g_size, 2 * m * d * n)

    for label, kernel, shape in KERNEL_TIMES if args.time else ():
        times[label] = timed(call(kernel, shape, torch.float32), flush)
        print(f"[bmm_bits] {label} ms={times[label]:.4f}", flush=True)
        torch.cuda.empty_cache()
    for label, shape in MATMUL_16_TIMES if args.time else ():
        times[label] = timed(call("matmul", shape, torch.bfloat16), flush)
        print(f"[bmm_bits] {label} ms={times[label]:.4f}", flush=True)
        torch.cuda.empty_cache()
    bounds = {}
    for label, kernel, shape in FUSED_16_TIMES if args.time else ():
        times[label] = timed(call(kernel, shape, torch.bfloat16), flush)
        torch.cuda.empty_cache()
        mm, nbytes, flops = matmul_route(kernel, shape, torch.bfloat16)
        times[f"{label} [matmul route]"] = timed(mm, flush)
        del mm
        t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / 989e12 * 1e3
        bounds[label] = max(t_bytes, t_ops)
        print(f"[bmm_bits] {label} ms={times[label]:.4f} matmul_route_ms="
              f"{times[label + ' [matmul route]']:.4f} bound_ms="
              f"{bounds[label]:.4f} "
              f"({'operations' if t_ops > t_bytes else 'bytes'})",
              flush=True)
        torch.cuda.empty_cache()
    for kernel, shape in KERNEL_BITS:
        for dt in (torch.bfloat16, torch.float16):
            out = call(kernel, shape, dt)()
            torch.cuda.synchronize()
            label = f"{kernel} {'x'.join(map(str, shape))} {dt}"
            meta[label] = ({torch.bfloat16: "bf16"}.get(dt, "f16"), shape[1])
            digests[label] = hashlib.sha256(
                out.contiguous().view(torch.uint8).cpu().numpy()
                .tobytes()).hexdigest()
            print(f"[bmm_bits] {label} sha256={digests[label]}", flush=True)
            del out
        torch.cuda.empty_cache()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"src": os.path.abspath(args.src), "seed": args.seed,
                       "card": card, "digests": digests, "meta": meta,
                       "ms": times, "bound_ms": bounds}, f, indent=1)
    print(f"[bmm_bits] {len(digests)} shapes", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
