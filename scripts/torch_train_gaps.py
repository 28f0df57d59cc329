"""Which leaf of a family's small f32 train state moves, card against CPU,
and how far each f32 kernel call on the way is from the exact product:
``chip_smoke.py``'s phase-15 ``_tf_small`` run (the family at its reduced
f32 width, five steps of the same numpy state on the card with the
kernels and on the CPU with their plain versions), compiled eagerly so
that every kernel call passes the wrappers here.

    python scripts/torch_train_gaps.py --arch llama-3.2-vision-11b
    python scripts/torch_train_gaps.py --root build/parent --plain swiglu

For each f32 matmul, norm_matmul, swiglu and batched_matmul shape on the
card it prints the worst error of the kernel and of its plain version
against the function in f64 (each over the f64 result's largest
magnitude) and their ratio, and then the leaves of m and v whose
card-vs-CPU gap (L2 over the CPU's norm, as ``_state_gaps`` measures it)
is largest, and the state's gaps against phase 15's limits
(``chip_smoke.STATE_LIMITS``).  ``--plain K,...``
runs those kernels' plain versions on the card instead, to see which
kernel moves a gap.  ``--root`` runs another checkout.  ``--gates`` runs
instead phase 15's ``_tf_small`` gate itself (captured, as phase 15 runs
it) for each family of ``chip_smoke.TF_ARCHS`` and prints its gaps; it
raises on the first family that fails.  Needs a card.

    python scripts/torch_train_gaps.py --gates
"""
from __future__ import annotations

import argparse
import collections
import os
import sys


def _f64(name, ops, eps=1e-6):
    """The kernel's function in f64 (the plain versions in ``ref`` compute
    in f32 whatever they are given)."""
    import torch
    if name == "swiglu":
        x, wg, wu, wd = ops
        g = x @ wg
        return (g * torch.reciprocal(torch.exp(-g) + 1) * (x @ wu)) @ wd
    if name == "norm_matmul":
        x, g, w = ops
        inv = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        return (x * inv * g) @ w
    return ops[0] @ ops[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout (default: this one)")
    ap.add_argument("--arch", default="llama-3.2-vision-11b")
    ap.add_argument("--plain", default="",
                    help="kernels to run as their plain versions on the card")
    ap.add_argument("--leaves", type=int, default=6)
    ap.add_argument("--gates", action="store_true",
                    help="run phase 15's small-train gate for every family")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("[train_gaps] no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs   # puts root/src first on sys.path
    from repro_torch import kernels
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.devices import to_numpy
    from repro_torch.kernels import ref

    if args.gates:   # _tf_small's limits: the losses at the update's
        limits = {**cs.STATE_LIMITS["f32"], "update": cs.TF_UPDATE_L2,
                  "loss": cs.STATE_LIMITS["f32"]["update"]}
        for arch in cs.TF_ARCHS:
            gaps = cs._tf_small(arch)
            print(f"[train_gaps] gate arch={arch} " + " ".join(
                f"{k}={v:.3e}" + (f"/{limits[k]:.0e}" if k in limits else "")
                for k, v in gaps.items()), flush=True)
        return 0
    plain = {k for k in args.plain.split(",") if k}
    cfg = get_config(args.arch).reduced(opt_dtype="f32",
                                        **cs.TF_SMALL[args.arch])
    ts, donate = cs._train_step_graph(cfg, cs.SMALL_BATCH, cs.SMALL_SEQ)
    batches = cs._train_batches(cfg, ts, cs.SMALL_BATCH, cs.SMALL_SEQ,
                                range(cs.SMALL_STEPS))
    params = ts.graphs.builder.init_params(0)
    for name in cs.MM_GATES:
        if name in params:
            params[name][...] = 0.5
    host = [params[n] for n in ts.param_names]
    host += [np.zeros_like(a) for a in host] * 2

    plains = {"matmul": ref.matmul_ref, "swiglu": ref.swiglu_ref,
              "norm_matmul": ref.norm_matmul_ref,
              "batched_matmul": ref.batched_matmul_ref}
    errs = collections.defaultdict(lambda: [0, 0.0, 0.0])

    def watch(name, fn):
        def call(*a, **kw):
            f32 = a[0].is_cuda and a[0].dtype == torch.float32
            if f32 and name in plain:
                return plains[name](*a, **kw)
            out = fn(*a, **kw)
            if f32:
                ops = [t for t in a if isinstance(t, torch.Tensor)]
                exact = _f64(name, [t.double() for t in ops], *a[3:], **kw)
                scale = float(exact.abs().max()) or 1.0
                e = errs[(name, tuple(tuple(t.shape) for t in ops))]
                e[0] += 1
                e[1] = max(e[1], float((out.double() - exact).abs().max())
                           / scale)
                e[2] = max(e[2], float((plains[name](*a, **kw).double()
                                        - exact).abs().max()) / scale)
            return out
        return call

    wrapped = {n: getattr(m, n) for n, m in kernels.MODULES.items()}
    states = {}
    try:
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                for n in plains:
                    setattr(kernels.MODULES[n], n, watch(n, wrapped[n]))
            cf = Backend.create("torch", fresh=True, device=dev).compile(
                ts.fn, CompileOptions(level="O2", use_pallas=True,
                                      donate_argnums=donate,
                                      static_jit=False))
            flat = [torch.from_numpy(a.copy()).to(dev) for a in host]
            _, _, _, flat = cs._train_steps(cf, flat, batches, required=(),
                                            label=f"{args.arch} {dev}")
            states[dev] = [to_numpy(t) for t in flat]
            for n, f in wrapped.items():
                setattr(kernels.MODULES[n], n, f)
    finally:
        for n, f in wrapped.items():
            setattr(kernels.MODULES[n], n, f)
    print(f"[train_gaps] root={os.path.abspath(args.root)} arch={args.arch} "
          f"plain_on_card={sorted(plain)}", flush=True)
    for (name, shapes), (calls, ek, ep) in sorted(
            errs.items(), key=lambda kv: -kv[1][1]):
        print(f"[train_gaps] kernel={name} shapes={shapes} calls={calls} "
              f"kernel_err={ek:.3e} plain_err={ep:.3e} "
              f"ratio={ek / ep if ep else float('nan'):.2f}")
    n = len(ts.param_names)
    rows = []
    for i, leaf in enumerate(ts.param_names):
        for kind, j in (("m", n + i), ("v", 2 * n + i)):
            a = states["cpu"][j].astype(np.float64)
            b = states["cuda"][j].astype(np.float64)
            norm = float(np.linalg.norm(a))
            rows.append((float(np.linalg.norm(b - a)) / max(norm, 1e-300),
                         kind, leaf, norm))
    for gap, kind, leaf, norm in sorted(rows, reverse=True)[:args.leaves]:
        print(f"[train_gaps] leaf={leaf} state={kind} gap={gap:.3e} "
              f"norm={norm:.3e}")
    gaps = cs._state_gaps(host[:n], states["cpu"], states["cuda"])
    limits = cs.STATE_LIMITS["f32"]
    print("[train_gaps] state " + " ".join(
        f"{k}={v:.3e}/{limits[k]:.0e}" if k in limits else f"{k}={v:.3e}"
        for k, v in gaps.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
