"""Is wgmma's k16 step bitwise mma.sync's?  (``csrc/wgmma_probe.cu``.)

The port's 16-bit K order names chains of ``mma.sync m16n8k16`` steps
(:func:`ops.matmul_k_order`).  A ``wgmma`` route keeps its bits only if
one k16 step of ``wgmma.mma_async m64nNk16`` rounds as one of mma.sync
from the same accumulator.  :func:`probe` runs the same chains both ways
-- 32 k16 steps from zeroed accumulators, scale-d 1 -- in bf16 and f16,
with wgmma's operands in each of the mainloop's four shared-memory
layouts and in flash attention's (``FLASH_MODES``: the scores' m64n64k16
with Q and K K-major; p.V with A from registers and V MN-major, from
accumulators loaded from memory, as flash's rescaled ``acc * alpha``),
over inputs drawn to find a difference: normal values, products spread
over 2^-40 to 2^40 (f16: its range) within one k16 group, a large
carried sum against small products, exact cancellation, and subnormal
values (each kind with starting accumulators of its own scale).  Every
output bit is compared.

``python -m repro_torch.kernels.wgmma_probe`` prints the verdict line on
the card.
"""
from __future__ import annotations

import json
import sys
from typing import Dict

import torch

from . import _build

PM, PN = 64, 128          # one problem's output tile
K = 512                   # 32 k16 steps
PROBLEMS = 2048           # 2^24 outputs a layout and type
LAYOUTS = {0: "A K-major, B MN-major", 1: "A MN-major, B MN-major",
           2: "A K-major, B K-major", 3: "A MN-major, B K-major"}
# flash attention's products: (mode, from a loaded accumulator) -> name
FLASH_MODES = {
    4: (True, "p.V: A registers, B MN-major, n128, from memory"),
    5: (True, "p.V: A registers, B MN-major, n64 halves, from memory"),
    6: (False, "scores: A K-major, B K-major, n64 halves")}
KINDS = ("normal", "spread", "carried", "cancel", "subnormal")


def _values(shape, lo: int, hi: int, gen: torch.Generator,
            device) -> torch.Tensor:
    """Signed values (1 + u) * 2^e, e uniform in [lo, hi], as f32."""
    e = torch.randint(lo, hi + 1, shape, generator=gen, device=device)
    u = torch.rand(shape, generator=gen, device=device)
    s = torch.randint(0, 2, shape, generator=gen, device=device) * 2 - 1
    return s * (1 + u) * torch.exp2(e.float())


def inputs(dtype: torch.dtype, device, seed: int = 0):
    """(A (P, 64, K), B (P, K, 128), C0 (P, 64, 128) f32, kind of each
    problem): PROBLEMS / 5 problems of each kind in KINDS, in that order;
    C0 is the starting accumulator of the modes that load one."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bf = dtype == torch.bfloat16
    n = PROBLEMS // len(KINDS)
    counts = [n] * (len(KINDS) - 1) + [PROBLEMS - n * (len(KINDS) - 1)]
    a_parts, b_parts, c_parts, kinds = [], [], [], []
    for i, (kind, p) in enumerate(zip(KINDS, counts)):
        sa, sb, sc = (p, PM, K), (p, K, PN), (p, PM, PN)
        if kind == "normal":
            a = torch.randn(sa, generator=gen, device=device)
            b = torch.randn(sb, generator=gen, device=device)
            c0 = torch.randn(sc, generator=gen, device=device) * 8
        elif kind == "spread":
            lo, hi = (-20, 20) if bf else (-14, 14)
            a = _values(sa, lo, hi, gen, device)
            b = _values(sb, lo, hi, gen, device)
            c0 = _values(sc, 2 * lo, 2 * hi, gen, device)
        elif kind == "carried":
            # the first 4 k16 steps large, the rest small: a large sum
            # carried into steps whose products are far below it
            big, small = (14, 4) if bf else (6, -2)
            a = _values(sa, -small - 10, small, gen, device)
            b = _values(sb, -small - 10, small, gen, device)
            a[:, :, :64] = _values((p, PM, 64), big - 2, big, gen, device)
            b[:, :64, :] = _values((p, 64, PN), big - 2, big, gen, device)
            # a large carried accumulator from the start
            c0 = _values(sc, 2 * big, 2 * big + 6, gen, device)
        elif kind == "cancel":
            # k and k + 8 of each k16 group give x and -x: every group
            # sums to exactly 0, and in half the problems one small
            # product is left in place of the last pair
            a = _values(sa, -8, 8, gen, device)
            b = _values(sb, -8, 8, gen, device)
            g = a.view(p, PM, K // 16, 2, 8)
            g[:, :, :, 1, :] = -g[:, :, :, 0, :]
            gb = b.view(p, K // 16, 2, 8, PN)
            gb[:, :, 1, :, :] = gb[:, :, 0, :, :]
            half = p // 2
            a.view(p, PM, K // 16, 16)[:half, :, :, 15] = _values(
                (half, PM, K // 16), -12, -6, gen, device)
            # a row of negative zeros: products of -0
            a[half:, ::7, :] = -0.0
            # accumulators of -0 and +0, and small ones the products cancel
            # around
            c0 = _values(sc, -14, -6, gen, device)
            c0[:, ::3, :] = -0.0
            c0[:, 1::3, :] = 0.0
        else:   # subnormal values (bf16: subnormal f32 products too)
            lo, hi = (-75, -60) if bf else (-24, -14)
            a = _values(sa, lo, hi, gen, device)
            b = _values(sb, lo, hi, gen, device)
            if bf:   # some normal operands beside them
                b[:, ::5, :] = _values((p, (K + 4) // 5, PN), -2, 2, gen,
                                       device)
            # subnormal f32 accumulators
            c0 = _values(sc, -140, -127, gen, device)
        a_parts.append(a.to(dtype))
        b_parts.append(b.to(dtype))
        c_parts.append(c0.float())
        kinds += [i] * p
    return (torch.cat(a_parts).contiguous(), torch.cat(b_parts).contiguous(),
            torch.cat(c_parts).contiguous(),
            torch.tensor(kinds, device=device))


def run(a: torch.Tensor, b: torch.Tensor, mode: int,
        c0: torch.Tensor = None) -> torch.Tensor:
    """C (P, 64, 128) f32 of mode -1 (mma.sync), 0-3 and 6 (wgmma), or,
    from the accumulators ``c0``, -2 (mma.sync), 4 and 5 (wgmma, A from
    registers)."""
    c = (c0.clone() if c0 is not None else
         torch.empty((a.shape[0], PM, PN), dtype=torch.float32,
                     device=a.device))
    _build.launch("repro_wgmma_probe", a.device, a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), a.shape[0], K, _build.dtype_code(a, "probe"),
                  mode, _build.stream(a))
    return c


def probe(device="cuda", seed: int = 0) -> Dict:
    """Compare every output bit of mma.sync and wgmma chains; returns
    ``{"equal", "outputs", "first_diff", "per"}``, ``per`` each type and
    layout's mismatches (by kind of input) and largest difference."""
    device = torch.device(device)
    outputs, first, per = 0, None, {}
    modes = {m: (False, name) for m, name in LAYOUTS.items()}
    modes.update(FLASH_MODES)
    for dtype in (torch.bfloat16, torch.float16):
        a, b, c0, kinds = inputs(dtype, device, seed)
        refs = {False: run(a, b, -1), True: run(a, b, -2, c0)}
        for mode, (loaded, name) in modes.items():
            ref = refs[loaded]
            ref_bits = ref.view(torch.int32)
            got = run(a, b, mode, c0 if loaded else None)
            diff = got.view(torch.int32) != ref_bits
            n = int(diff.sum())
            outputs += diff.numel()
            by_kind = diff.flatten(1).sum(1)
            fin = torch.isfinite(ref) & torch.isfinite(got)
            per[f"{str(dtype)[6:]} {name}"] = {
                "mismatches": n,
                "by_kind": {kd: int(by_kind[kinds == i].sum())
                            for i, kd in enumerate(KINDS)},
                "max_abs_diff": float((got - ref)[fin].abs().max()),
                "max_abs": float(ref[fin].abs().max())}
            if n and first is None:
                p, m, col = (int(v) for v in diff.nonzero()[0])
                first = {"dtype": str(dtype)[6:], "layout": name,
                         "kind": KINDS[int(kinds[p])], "problem": p,
                         "row": m, "col": col,
                         "mma_sync": float(ref[p, m, col]),
                         "wgmma": float(got[p, m, col]),
                         "mma_sync_bits": hex(int(ref_bits[p, m, col]) &
                                              0xFFFFFFFF),
                         "wgmma_bits": hex(int(got.view(torch.int32)
                                               [p, m, col]) & 0xFFFFFFFF),
                         "a_row": a[p, m].float().tolist(),
                         "b_col": b[p, :, col].float().tolist()}
    return {"equal": first is None, "outputs": outputs, "first_diff": first,
            "per": per}


def verdict_line(r: Dict) -> str:
    first = r["first_diff"]
    if first is not None:
        first = {k: v for k, v in first.items() if k not in ("a_row",
                                                           "b_col")}
    return (f"[wgmma_probe] equal={str(r['equal']).lower()} "
            f"outputs={r['outputs']} first_diff={json.dumps(first)}")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("wgmma_probe: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    r = probe()
    print(verdict_line(r))
    print(json.dumps(r["per"]))
    if r["first_diff"] is not None:
        print(json.dumps(r["first_diff"]))
