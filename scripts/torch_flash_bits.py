"""Output bits of flash attention's 16-bit routes at phase 3's shapes, as
sha256 digests, so that two checkouts can be shown to give the same bits
on the card; with ``--time``, the times of the 16-bit shapes that phase 3
reports against SDPA (``TIMES16``), of prefills on both sides of the
wgmma route's threshold on each route (``ROUTE_SHAPES``) and of the f32
route at the shapes the serving phases launch (and SDPA's, in the same
process), so that one call on one card compares two checkouts'
kernels.  The kernel comes from
``repro_torch.kernels`` of the tree ``--src`` names (the parent unpacked
into a git-ignored directory):

    python scripts/torch_flash_bits.py --src build/parent/src --time --json results/p1.json
    python scripts/torch_flash_bits.py --time --json results/c1.json
    python scripts/torch_flash_bits.py --time --json results/c2.json
    python scripts/torch_flash_bits.py --src build/parent/src --time --json results/p2.json
    python scripts/torch_flash_bits.py --compare results/p1.json results/c1.json

Operands are drawn on the card from ``--seed`` (the same draws whatever
the tree).  A time is ``chip_smoke.py``'s phase 3 measure: the median of
20 launches, each timed with CUDA events after a 512 MB write that
flushes L2 and keeps the card busy while the host enqueues; each f32
shape also reports the kernel's largest error against the plain version
over the scale max(max |plain|, 1), and its f32 digest (which a change
of the f32 route may move by design).  ``--compare`` prints each timed
shape side by side and exits 1 when a shape is missing or a 16-bit
digest differs, except the digests the 16-bit order itself may move:
those of the shapes some row of which sees keys in more than one chunk
of ``ops.FLASH_CHUNK`` keys (:func:`multi_chunk`: mixtral's and rg's
long prefill and decode), which are counted; so are the f32 digests that
moved.  Needs a card; the compare needs none.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

# (label, B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, offset): phase 3's
# 16-bit shapes (chip_smoke.kernel_cases and its determinism checks), and
# ragged ones that take every head-width class and the padded widths
BITS16 = (
    ("decode 4x32x1 at pos 255", 4, 32, 32, 1, 256, 128, 128, True, None,
     255),
    ("decode 4x32x1 at pos 63", 4, 32, 32, 1, 256, 128, 128, True, None, 63),
    ("dense prefill 4x32x128", 4, 32, 32, 128, 128, 128, 128, True, None,
     None),
    ("paged-dense prefill 1x32x100", 1, 32, 32, 100, 100, 128, 128, True,
     None, None),
    ("GQA decode 64:8 at pos 255", 4, 64, 8, 1, 256, 128, 128, True, None,
     255),
    ("decode 16x32x1 at pos 255", 16, 32, 32, 1, 256, 128, 128, True, None,
     255),
    ("train 4x32x512", 4, 32, 32, 512, 512, 128, 128, True, None, None),
    ("MLA prefill 4x128x64 Dk 192 Dv 128", 4, 128, 128, 64, 64, 192, 128,
     True, None, None),
    ("mixtral prefill 1x48x4224 48:8 window 4096", 1, 48, 8, 4224, 4224,
     128, 128, True, 4096, None),
    ("mixtral decode 1x48x1 at pos 4223 window 4096", 1, 48, 8, 1, 4224,
     128, 128, True, 4096, 4223),
    ("minicpm decode 4x36x1 d64 at pos 255", 4, 36, 36, 1, 256, 64, 64, True,
     None, 255),
    ("minicpm prefill 4x36x128 d64", 4, 36, 36, 128, 128, 64, 64, True, None,
     None),
    ("rg prefill 4x16x128 16:1 Dk 256 window 2048", 4, 16, 1, 128, 128, 256,
     256, True, 2048, None),
    ("rg prefill 1x16x2176 16:1 Dk 256 window 2048", 1, 16, 1, 2176, 2176,
     256, 256, True, 2048, None),
    ("rg decode 1x16x1 at pos 2183 window 2048", 1, 16, 1, 1, 2184, 256, 256,
     True, 2048, 2183),
    ("ragged 2x4x3 over 130 at 127", 2, 4, 4, 3, 130, 128, 128, True, None,
     127),
    ("ragged 1x2x17 over 70 Dk 192 Dv 128 no mask", 1, 2, 1, 17, 70, 192,
     128, False, None, None),
    ("ragged 1x2x64 Dk 40", 1, 2, 2, 64, 64, 40, 40, True, None, None),
    ("ragged 1x2x128 over 256 Dk 72 Dv 56 at 128", 1, 2, 2, 128, 256, 72, 56,
     True, None, 128),
    # the wgmma route's head-width classes at one chunk (the parent's
    # mma.sync route gives the same bits) and a ragged one past it
    ("minicpm prefill 2x36x300 d64", 2, 36, 36, 300, 300, 64, 64, True,
     None, None),
    ("MLA prefill 1x16x300 Dk 192 Dv 128", 1, 16, 16, 300, 300, 192, 128,
     True, None, None),
    ("rg prefill 1x16x300 16:1 Dk 256 window 256", 1, 16, 1, 300, 300, 256,
     256, True, 256, None),
    ("ragged 1x2x300 over 330 Dk 40 at 30", 1, 2, 2, 300, 330, 40, 40, True,
     None, 30),
    ("ragged 1x2x257 over 512 Dk 72 Dv 56 at 255", 1, 2, 1, 257, 512, 72, 56,
     True, None, 255),
    ("deepseek prefill 1x32x1100", 1, 32, 32, 1100, 1100, 128, 128, True,
     None, None),
)
# the 16-bit shapes phase 3 times against SDPA: the long ones this
# order and its routes were redesigned for, then shapes that keep their
# route (decodes over <= 512 keys, prefills under ops.FLASH_WG_MIN_SQ rows)
TIMES16 = (
    ("bf16 train 4x32x512 causal", 4, 32, 32, 512, 512, 128, 128, True,
     None, None),
    ("bf16 mixtral prefill 1x48x4224 48:8 window 4096", 1, 48, 8, 4224,
     4224, 128, 128, True, 4096, None),
    ("bf16 mixtral decode 1x48x1 at pos 4223 window 4096", 1, 48, 8, 1, 4224,
     128, 128, True, 4096, 4223),
    ("bf16 rg decode 1x16x1 16:1 Dk 256 at pos 2183 window 2048", 1, 16, 1,
     1, 2184, 256, 256, True, 2048, 2183),
    ("bf16 rg prefill 1x16x2176 16:1 Dk 256 window 2048", 1, 16, 1, 2176,
     2176, 256, 256, True, 2048, None),
    ("bf16 whisper cross-attention 4x16x64 Dk 64 over 1500", 4, 16, 16, 64,
     1500, 64, 64, False, None, None),
    ("bf16 MLA prefill 4x128x64 Dk 192 Dv 128", 4, 128, 128, 64, 64, 192,
     128, True, None, None),
    ("bf16 vlm cross-attention 4x32x128 32:8 over 1601", 4, 32, 8, 128,
     1601, 128, 128, False, None, None),
    ("bf16 decode 4x32x1 at pos 255", 4, 32, 32, 1, 256, 128, 128, True,
     None, 255),
    ("bf16 GQA decode 4x64x1 64:8 at pos 255", 4, 64, 8, 1, 256, 128, 128,
     True, None, 255),
    ("bf16 decode 16x32x1 at pos 255", 16, 32, 32, 1, 256, 128, 128, True,
     None, 255),
    ("bf16 dense prefill 4x32x128", 4, 32, 32, 128, 128, 128, 128, True,
     None, None),
    ("bf16 minicpm decode 4x36x1 d64 at pos 255", 4, 36, 36, 1, 256, 64, 64,
     True, None, 255),
    ("bf16 minicpm prefill 4x36x128 d64", 4, 36, 36, 128, 128, 64, 64, True,
     None, None),
    ("bf16 rg prefill 4x16x128 16:1 Dk 256", 4, 16, 1, 128, 128, 256, 256,
     True, 2048, None),
    ("bf16 rg decode 4x16x1 at pos 143 Dk 256", 4, 16, 1, 1, 144, 256, 256,
     True, 2048, 143),
)
# the prefills on both sides of ops.FLASH_WG_MIN_SQ, timed on each 16-bit
# route (``--time``, where the tree has the wgmma route): what sets the
# threshold
ROUTE_SHAPES = (
    ("bf16 prefill 4x32x128 d128", 4, 32, 32, 128, 128, 128, 128, True,
     None, None),
    ("bf16 prefill 4x32x256 d128", 4, 32, 32, 256, 256, 128, 128, True,
     None, None),
    ("bf16 prefill 4x36x128 d64 (minicpm)", 4, 36, 36, 128, 128, 64, 64,
     True, None, None),
    ("bf16 prefill 4x36x256 d64 (minicpm)", 4, 36, 36, 256, 256, 64, 64,
     True, None, None),
    ("bf16 prefill 4x16x128 16:1 Dk 256 (rg)", 4, 16, 1, 128, 128, 256, 256,
     True, 2048, None),
    ("bf16 prefill 4x16x256 16:1 Dk 256 (rg)", 4, 16, 1, 256, 256, 256, 256,
     True, 2048, None),
)
# the f32 route: phase 3's decode, phase 14's three launched shapes,
# phase 16's (reduced width, and its 32-head prompts), and the families'
F32_TIMES = (
    ("f32 decode 4x32x1 at pos 255", 4, 32, 32, 1, 256, 128, 128, True,
     None, 255),
    ("f32 decode 4x32x1 over 64 keys at pos 63 (phase 14)", 4, 32, 32, 1, 64,
     128, 128, True, None, 63),
    ("f32 prompt prefill 1x32x32 (phase 14)", 1, 32, 32, 32, 32, 128, 128,
     True, None, None),
    ("f32 prompt prefill 4x32x32 (phase 14)", 4, 32, 32, 32, 32, 128, 128,
     True, None, None),
    ("f32 prefill 1x2x256 (phase 16)", 1, 2, 2, 256, 256, 128, 128, True,
     None, None),
    ("f32 prefill 1x32x4 (phase 16)", 1, 32, 32, 4, 4, 128, 128, True, None,
     None),
    ("f32 prefill 1x32x6 (phase 16)", 1, 32, 32, 6, 6, 128, 128, True, None,
     None),
    ("f32 prefill 1x32x8 (phase 16)", 1, 32, 32, 8, 8, 128, 128, True, None,
     None),
    ("f32 prefill 1x32x12 (phase 16)", 1, 32, 32, 12, 12, 128, 128, True,
     None, None),
    ("f32 prefill 1x32x16 (phase 16)", 1, 32, 32, 16, 16, 128, 128, True,
     None, None),
    ("f32 GQA decode 4x64x1 64:8 at pos 255 (qwen1.5-110b)", 4, 64, 8, 1,
     256, 128, 128, True, None, 255),
    ("f32 prefill 4x32x128", 4, 32, 32, 128, 128, 128, 128, True, None,
     None),
    ("f32 cross-attention 4x16x64 Dk 64 over 1500 (whisper-medium)", 4, 16,
     16, 64, 1500, 64, 64, False, None, None),
    ("f32 MLA prefill 4x128x64 Dk 192 Dv 128 (deepseek-v3)", 4, 128, 128, 64,
     64, 192, 128, True, None, None),
    ("f32 windowed decode 1x16x1 16:1 Dk 256 at pos 2183 window 2048 (rg)",
     1, 16, 1, 1, 2184, 256, 256, True, 2048, 2183),
    ("f32 decode 16x32x1 at pos 255", 16, 32, 32, 1, 256, 128, 128, True,
     None, 255),
)


def multi_chunk(shape, chunk: int) -> bool:
    """Whether some query row of a BITS16 ``shape`` sees keys in more than
    one chunk of ``chunk`` keys (the 16-bit order's chunks, by absolute
    key index): only such a row's bits may differ from the unchunked
    order's."""
    _, B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, off = shape
    base = off if off is not None else 0
    for i in range(Sq):
        p = base + i
        lo = max(0, p - window + 1) if window is not None else 0
        hi = min(p, Skv - 1) if causal else Skv - 1
        if hi >= lo and lo // chunk != hi // chunk:
            return True
    return False


def compare(a_path: str, b_path: str, chunk: int = None) -> int:
    """Exit code of ``--compare``: 1 when a shape is missing from either
    file or a 16-bit digest differs, except those of the shapes
    :func:`multi_chunk` names (``chunk``: the order's chunk, by default
    ``ops.FLASH_CHUNK`` of this checkout), which the order may move; f32
    digests that moved are counted too."""
    if chunk is None:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src"))
        from repro_torch.kernels import ops
        chunk = ops.FLASH_CHUNK
    may_move = {f"{sh[0]} {dt}" for sh in BITS16 if multi_chunk(sh, chunk)
                for dt in ("bfloat16", "float16")}
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    for label, ms in a["ms"].items():
        print(f"[flash_bits] {label}: {ms:.4f} -> "
              f"{b['ms'].get(label, float('nan')):.4f} ms (sdpa "
              f"{a['sdpa_ms'].get(label, float('nan')):.4f} / "
              f"{b['sdpa_ms'].get(label, float('nan')):.4f})")
    bad, moved, chunked, same = [], [], [], 0
    da, db = a["digests"], b["digests"]
    for k in sorted(set(da) | set(db)):
        if da.get(k) == db.get(k):
            same += 1
        elif k in da and k in db and k.startswith("f32 "):
            moved.append(k)
        elif k in da and k in db and k in may_move:
            chunked.append(k)
        else:
            bad.append(k)
    for k in chunked:
        print(f"[flash_bits] moved by the chunked order: {k}")
    for k in bad:
        print(f"[flash_bits] DIFFERS {k}: {da.get(k)} vs {db.get(k)}")
    print(f"[flash_bits] compared {len(set(da) | set(db))} digests: "
          f"{len(bad)} differ, {len(chunked)} 16-bit moved by the chunked "
          f"order (of {len(may_move)} that may), {len(moved)} f32 moved, "
          f"{same} equal")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"),
        help="the tree's src directory (default: this checkout's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", help="write the digests (and times) here")
    ap.add_argument("--time", action="store_true",
                    help="also time the 16-bit shapes (TIMES16), the f32 "
                         "shapes (F32_TIMES) and SDPA")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)

    import torch
    import torch.nn.functional as Fn
    if not torch.cuda.is_available():
        print("[flash_bits] no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"[flash_bits] src={os.path.abspath(args.src)} module="
          f"{kf.__file__} card={card!r}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    def operands(B, Hq, Hkv, Sq, Skv, Dk, Dv, dt):
        return [torch.randn(s, generator=gen, device="cuda").to(dt)
                for s in ((B, Hq, Sq, Dk), (B, Hkv, Skv, Dk),
                          (B, Hkv, Skv, Dv))]

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

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()

    digests, times, sdpa, errs = {}, {}, {}, {}
    for label, B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, off in BITS16:
        for dt in (torch.bfloat16, torch.float16):
            q, k, v = operands(B, Hq, Hkv, Sq, Skv, Dk, Dv, dt)
            o = None if off is None else torch.tensor(
                off, dtype=torch.int32, device="cuda")
            out = kf.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=o)
            torch.cuda.synchronize()
            key = f"{label} {str(dt).split('.')[-1]}"
            digests[key] = digest(out)
            print(f"[flash_bits] {key} sha256={digests[key]}", flush=True)
            del q, k, v, out
        torch.cuda.empty_cache()
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")

    def sdpa_call(q, k, v, Hq, Hkv, Sq, Skv, causal, window, off):
        kr, vr = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
        if off is None and window is None and causal:
            return lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                q, kr, vr, is_causal=True)
        vis = ref.attention_mask(Sq, Skv, causal=causal, window=window,
                                 q_offset=off, device="cuda")
        return lambda: Fn.scaled_dot_product_attention(  # noqa: E731
            q, kr, vr, attn_mask=vis)

    for label, B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, off in (
            TIMES16 if args.time else ()):
        q, k, v = operands(B, Hq, Hkv, Sq, Skv, Dk, Dv, torch.bfloat16)
        o = None if off is None else torch.tensor(off, dtype=torch.int32,
                                                  device="cuda")
        times[label] = timed(lambda: kf.flash_attention(
            q, k, v, causal=causal, window=window, q_offset=o), flush)
        sdpa[label] = timed(sdpa_call(q, k, v, Hq, Hkv, Sq, Skv, causal,
                                      window, off), flush)
        print(f"[flash_bits] {label} ms={times[label]:.4f} "
              f"sdpa_ms={sdpa[label]:.4f}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    from repro_torch.kernels import ops
    routes = {}
    for label, B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, off in (
            ROUTE_SHAPES if args.time and hasattr(ops, "FLASH_WG_MIN_SQ")
            else ()):
        # (a generator of its own: the draws after it are both trees')
        rgen = torch.Generator(device="cuda")
        rgen.manual_seed(args.seed)
        q, k, v = [torch.randn(s, generator=rgen, device="cuda")
                   .to(torch.bfloat16)
                   for s in ((B, Hq, Sq, Dk), (B, Hkv, Skv, Dk),
                             (B, Hkv, Skv, Dv))]
        saved, routes[label] = ops.FLASH_WG_MIN_SQ, {}
        for route, rows in (("wgmma", 1), ("mma.sync", 1 << 30)):
            ops.FLASH_WG_MIN_SQ = rows
            routes[label][route] = timed(lambda: kf.flash_attention(
                q, k, v, causal=causal, window=window), flush)
        ops.FLASH_WG_MIN_SQ = saved
        print(f"[flash_bits] route {label}: " + " ".join(
            f"{r}={t:.4f}" for r, t in routes[label].items()), flush=True)
        del q, k, v
    for label, B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, off in F32_TIMES:
        q, k, v = operands(B, Hq, Hkv, Sq, Skv, Dk, Dv, torch.float32)
        o = None if off is None else torch.tensor(off, dtype=torch.int32,
                                                  device="cuda")

        def run():
            return kf.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=o)
        out = run()
        plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, q_offset=o)
        torch.cuda.synchronize()
        digests[label] = digest(out)
        errs[label] = float((out.double() - plain.double()).abs().max()) / \
            max(float(plain.double().abs().max()), 1.0)
        line = (f"[flash_bits] {label} sha256={digests[label]} "
                f"err_over_scale={errs[label]:.3e}")
        if args.time:
            times[label] = timed(run, flush)
            sdpa[label] = timed(sdpa_call(q, k, v, Hq, Hkv, Sq, Skv,
                                          causal, window, off), flush)
            line += f" ms={times[label]:.4f} sdpa_ms={sdpa[label]:.4f}"
        print(line, flush=True)
        del q, k, v, out, plain
        torch.cuda.empty_cache()
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"src": os.path.abspath(args.src), "seed": args.seed,
                       "card": card, "digests": digests, "ms": times,
                       "sdpa_ms": sdpa, "route_ms": routes,
                       "f32_err_over_scale": errs}, f,
                      indent=1)
    print(f"[flash_bits] {len(digests)} digests", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
