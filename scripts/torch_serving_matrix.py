"""The serving matrix on torch: every leg of the reference CI's serving
jobs (``.github/workflows/ci.yml``: serving-smoke, serving-shared-prefix,
serving-tp, serving-http, chaos) run by one driver, each writing its
report, then judged by the unchanged ``scripts/check_serving_matrix.py``
(imports only ``repro_torch``; the checker runs in a process of its own).

``python scripts/torch_serving_matrix.py --reduced --device cpu --out-dir DIR``
writes ``DIR/engine-report-<leg>.json`` for the eight legs and exits with
the checker's code:

  * ``donated`` (3 slots), ``continuous`` and ``paged`` (``--page-size 4
    --chunk-steps 3``): the standard greedy workload;
  * ``paged-shared-base`` and ``paged-shared-prefix``: one shared-prompt
    workload with prefix sharing off, then on;
  * ``paged-tp2``: the paged leg at ``--tp 2``;
  * ``server``: the HTTP front door, fed by concurrent load-generator
    clients tagged ``0..n-1``, then drained;
  * ``chaos``: ``scripts/torch_chaos_probe.py``'s report.

The engine and server legs go through ``repro_torch.launch.serve.main``
with the CI's flags letter for letter (:data:`CI_WORKLOAD`), so every
report is the serve CLI's own; the server listens on an ephemeral port
and its clients run in this process.  Without ``--reduced`` the legs run
:data:`FULL_WORKLOAD` at published widths, O2 with the kernels, weights
drawn on the device -- on a card, where the tp leg needs two cards
unless a caller passes a mesh that puts both shards on one
(:func:`run_matrix`'s ``tp_mesh``; ``chip_smoke.py`` phase 14 does, with
the depth cut in the config it passes).  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

CHECKER = os.path.join(REPO, "scripts", "check_serving_matrix.py")
CHAOS = os.path.join(REPO, "scripts", "torch_chaos_probe.py")

# the reference CI's serving jobs, flags letter for letter (the cache,
# autotune and smoke-warm flags of serving-smoke aside: they gate the
# disk cache, not the report); "server" is serving-http's serve command
# and its load driver's client count
_CI_STD = "--batch {slots} --requests 3 --prompt-len 4 --gen 6 --max-len 16"
_CI_SHARED = ("--batch 3 --requests 3 --prompt-len 16 --gen 4 --max-len 24 "
              "--mode paged --page-size 4 --chunk-steps 2 "
              "--shared-prefix-len 16")
CI_WORKLOAD: Dict[str, str] = {
    "donated": _CI_STD.format(slots=3) + " --mode donated --smoke",
    "continuous": _CI_STD.format(slots=2) + " --mode continuous --smoke",
    "paged": _CI_STD.format(slots=2)
    + " --mode paged --page-size 4 --chunk-steps 3 --smoke",
    "paged-shared-base": _CI_SHARED + " --no-prefix-sharing "
    "--report-leg paged-shared-base --smoke",
    "paged-shared-prefix": _CI_SHARED
    + " --report-leg paged-shared-prefix --smoke",
    "paged-tp2": _CI_STD.format(slots=2)
    + " --mode paged --page-size 4 --chunk-steps 3 --tp 2 "
    "--report-leg paged-tp2 --smoke",
    "server": "--serve-http --port 0 --batch 2 --requests 3 --prompt-len 4 "
    "--gen 6 --max-len 16 --page-size 4 --chunk-steps 3",
}
# every leg's --seed (weights at --reduced, and prompts).  The CI's is 0.
# At 0, 1 and 4 the port's donated leg and its continuous leg split a
# greedy token where the top two bf16 logits are one unit apart: donated
# decodes through the Attention op, which rounds its probabilities to
# bf16 before p.V (the reference's ``reference_attention``), continuous
# and paged through the row-position composition, which keeps them in
# f32.  The JAX reference splits seed 1 the same way.
# tests/test_torch_serving_matrix.py pins seed 0's split as such a tie.
MATRIX_SEED = 2

# published widths on the card: 4 slots and 4 requests of 32 prompt
# tokens and 16 new ones (max_len 64, page 16, 4 steps a dispatch); the
# shared pair: 3 requests whose 64-token prompts are one shared prefix of
# four whole pages, 8 new tokens, 2 steps a dispatch
_FULL = ("--batch 4 --requests 4 --prompt-len 32 --gen 16 --max-len 64 "
         "--level O2 --kernels")
_FULL_PAGED = _FULL + " --mode paged --page-size 16 --chunk-steps 4"
_FULL_SHARED = ("--batch 3 --requests 3 --prompt-len 64 --gen 8 --max-len 96 "
                "--mode paged --page-size 16 --chunk-steps 2 "
                "--shared-prefix-len 64 --level O2 --kernels")
FULL_WORKLOAD: Dict[str, str] = {
    "donated": _FULL + " --mode donated --smoke",
    "continuous": _FULL + " --mode continuous --smoke",
    "paged": _FULL_PAGED + " --smoke",
    "paged-shared-base": _FULL_SHARED + " --no-prefix-sharing "
    "--report-leg paged-shared-base --smoke",
    "paged-shared-prefix": _FULL_SHARED
    + " --report-leg paged-shared-prefix --smoke",
    "paged-tp2": _FULL_PAGED + " --tp 2 --report-leg paged-tp2 --smoke",
    "server": "--serve-http --port 0 " + _FULL
    + " --page-size 16 --chunk-steps 4",
}

LEGS = ("donated", "continuous", "paged", "paged-shared-base",
        "paged-shared-prefix", "paged-tp2", "server", "chaos")


def report_path(out_dir: str, leg: str) -> str:
    return os.path.join(out_dir, f"engine-report-{leg}.json")


def _flag(args: List[str], name: str) -> Optional[str]:
    return args[args.index(name) + 1] if name in args else None


def _drive_clients(cfg, args: List[str]):
    """serving-http's load driver: one tagged streaming client per
    request, all concurrent, on the serve CLI's prompts; every client
    must get 200 and all its tokens."""
    from repro_torch.launch import loadgen

    n = int(_flag(args, "--requests"))
    P, G = int(_flag(args, "--prompt-len")), int(_flag(args, "--gen"))
    seed = int(_flag(args, "--seed"))

    def drive(base_url: str) -> None:
        loadgen.wait_ready(base_url, timeout=600)
        prompts = loadgen.make_prompts(n, P, cfg.vocab, seed=seed)
        res = loadgen.run_load(base_url, prompts, G)
        print(f"[matrix:server] {n} clients x {G} tokens: "
              f"statuses={res.statuses} ttft p50 {res.ttft_p50_ms:.1f}ms "
              f"p95 {res.ttft_p95_ms:.1f}ms", flush=True)
        short = [t for t, toks in res.results.items() if len(toks) != G]
        if res.statuses != {200: n} or res.errors or short:
            raise RuntimeError(f"server leg: statuses {res.statuses}, "
                               f"errors {res.errors}, short {short}")
    return drive


def _free(device: str) -> None:
    """Drop every backend's compiled functions (a captured graph keeps
    its memory pool) before the next leg builds its engine."""
    if not device.startswith("cuda"):
        return
    import torch
    from repro_torch.backend import Backend
    for be in list(Backend._INSTANCES.values()):
        be.clear_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def run_matrix(cfg, device: str, out_dir: str, *, params=None,
               tp_mesh=None, workload: Dict[str, str] = CI_WORKLOAD,
               seed: int = MATRIX_SEED, reduced: bool = False,
               legs: tuple = LEGS) -> Dict[str, dict]:
    """Run the ``legs`` (default all eight) of ``workload`` (serve CLI
    flags per leg) on ``cfg`` and ``device``, each writing
    ``engine-report-<leg>.json`` into ``out_dir``; returns each leg's
    report path, seconds and, on a card, peak GB allocated.  ``params``
    (by name) serve every engine leg; without them ``reduced=True``
    (``cfg`` is its arch's ``.reduced()``; the legs take ``--reduced``)
    takes the builder's numpy init and otherwise the weights are drawn
    on the device for each leg.
    ``tp_mesh`` is the paged-tp2 leg's mesh (e.g. two shards on one
    card, ``make_mesh((2,), ("model",), devices=["cuda:0"] * 2)``);
    without it the leg's engine takes one card per shard and raises on
    a one-card machine.  ``seed`` is every leg's ``--seed``.  The chaos
    leg is ``scripts/torch_chaos_probe.py --device DEVICE`` in a process
    of its own (reduced, its own engines)."""
    from repro_torch.launch import serve

    os.makedirs(out_dir, exist_ok=True)
    # serve.main takes ``cfg`` as given; --arch only names it in argv
    head = (["--arch", cfg.name.removesuffix("-smoke"), "--reduced"]
            if reduced else ["--arch", cfg.name])
    ran: Dict[str, dict] = {}
    for leg in legs:
        if leg == "chaos":
            continue
        path = report_path(out_dir, leg)
        args = (head + workload[leg].split()
                + ["--seed", str(seed), "--device", device,
                   "--report-json", path])
        _free(device)
        t0 = time.perf_counter()
        rc = serve.main(args, cfg=cfg, params=params,
                        mesh=tp_mesh if leg == "paged-tp2" else None,
                        drive=(_drive_clients(cfg, args) if leg == "server"
                               else None))
        if rc != 0:
            raise RuntimeError(f"matrix leg {leg}: serve exited {rc}")
        ran[leg] = {"path": path,
                    "seconds": time.perf_counter() - t0,
                    "peak_gb": _peak_gb(device)}
    _free(device)
    if "chaos" not in legs:
        return ran
    path = report_path(out_dir, "chaos")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, CHAOS, "--device", device,
                           "--report-json", path],
                          capture_output=True, text=True, timeout=1200)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"matrix leg chaos: rc {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    ran["chaos"] = {"path": path, "seconds": time.perf_counter() - t0,
                    "peak_gb": None}
    return ran


def _peak_gb(device: str) -> Optional[float]:
    if not device.startswith("cuda"):
        return None
    import torch
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def check_reports(paths: List[str]) -> subprocess.CompletedProcess:
    """The unchanged checker on the reports, in a process of its own."""
    return subprocess.run([sys.executable, CHECKER, *paths],
                          capture_output=True, text=True, timeout=300)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu' (default: the card)")
    ap.add_argument("--seed", type=int, default=MATRIX_SEED)
    ap.add_argument("--out-dir", default="results/serving_matrix_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    legs = run_matrix(cfg, args.device, args.out_dir, seed=args.seed,
                      reduced=args.reduced,
                      workload=CI_WORKLOAD if args.reduced else FULL_WORKLOAD)
    for leg, info in legs.items():
        print(f"[matrix] leg={leg} seconds={info['seconds']:.2f} "
              f"report={info['path']}")
    proc = check_reports([info["path"] for info in legs.values()])
    print(proc.stdout, end="")
    print(proc.stderr, end="", file=sys.stderr)
    return proc.returncode


if __name__ == "__main__":
    raise SystemExit(main())
