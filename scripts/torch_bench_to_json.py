"""Snapshot the torch port's benchmark sections to JSON, and check a
snapshot: the counterpart of the reference's ``scripts/bench_to_json.py``
(imports only ``repro_torch``, ``torch`` and ``numpy``).

``python scripts/torch_bench_to_json.py --sections serving paged --out FILE
[--device cuda|cpu] [--reduced] [--layers N]`` runs the named
``scripts/torch_bench.py`` sections (on the card unless ``--device cpu``)
and writes their rows, with the device they ran on (``nvidia-smi``'s
``name, power.limit`` on the card, ``"cpu"`` otherwise), the model's
width and depth, and each section's seconds and kernel launches.  The
default path is ``results/bench_torch.json``; it never writes the
reference's ``BENCH_serve.json``.

``python scripts/torch_bench_to_json.py --check FILE`` validates a
snapshot without running anything, with the reference's invariants:
positive tok/s; the paged section's ``paged_kv_bytes_ratio < 1`` and
parity == 1; the server section over-subscribed, with parity and a clean
drain; the kernels section's ``*_selected_over_unfused <= 1`` and its
re-resolve and refusal invariants; the faults section's recovery rows ==
1; the prefix section's ``prefix_kv_bytes_ratio <= 0.6``, its three parity
rows == 1 and a copy-on-write; the partition section's tp=2 parity,
``kv_bytes_per_device_ratio <= 0.5``, an all-gather and a sharded
parameter.  When the snapshot's device is a card it also fails a section
whose kernel-launch rows sum to 0 or whose refusal rows are above 0, and
a compounding section without a flash launch.  Throughput ratios (E10's
donated against lockstep, E14's timings) are recorded, not gated.  Every
failure is a readable ``CHECK FAIL`` line naming what is missing against
what is present, and the exit code is non-zero.

``--autotune-dir DIR`` additionally validates every tuning record under
``DIR`` with ``repro_torch.backend.autotune``'s schema check.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "results", "bench_torch.json")

SCHEMA_VERSION = 1
REQUIRED_SERVING_ROWS = (
    "lockstep_tok_s", "lockstep_decode_tok_s",
    "donated_tok_s", "donated_decode_tok_s",
    "continuous_tok_s", "continuous_decode_tok_s",
    "continuous_ttft_p50_ms", "continuous_ttft_p95_ms",
    "donated_speedup_x", "donated_matches_lockstep",
    "continuous_matches_alone",
)
REQUIRED_PAGED_ROWS = (
    "paged_tok_s", "paged_decode_tok_s",
    "paged_kv_bytes_per_active_token",
    "continuous_kv_bytes_per_active_token",
    "paged_kv_bytes_ratio", "paged_matches_continuous",
    "paged_ttft_p95_ms",
)
REQUIRED_SERVER_ROWS = (
    "server_clients", "server_slots",
    "server_tok_s", "server_sustained_tok_s",
    "server_ttft_p50_ms", "server_ttft_p95_ms",
    "server_tok_p95_ms",
    "server_matches_engine", "server_drain_clean",
)
# E14: the reference's four tile rows and its fallback row are the port's
# kernel-against-torch.matmul rows and its counted refusal
REQUIRED_KERNELS_ROWS = (
    "swiglu_unfused_ms", "swiglu_fused_ms", "swiglu_selected_ms",
    "swiglu_selected_over_unfused",
    "norm_matmul_unfused_ms", "norm_matmul_fused_ms",
    "norm_matmul_selected_ms", "norm_matmul_selected_over_unfused",
    "matmul_tile_bm", "matmul_tile_bn",
    "matmul_kernel_ms", "matmul_torch_ms", "matmul_kernel_over_torch",
    "matmul_reresolve_sweep_free", "matmul_refused_ok",
)
REQUIRED_FAULTS_ROWS = (
    "faults_cancel_reclaim_ms",
    "faults_cancelled_total", "faults_deadline_total",
    "faults_engine_errors_total",
    "faults_dispatch_contained", "faults_pages_reclaimed",
    "faults_uninjected_parity",
)
REQUIRED_PREFIX_ROWS = (
    "prefix_shared_kv_bytes_per_token",
    "prefix_unshared_kv_bytes_per_token",
    "prefix_kv_bytes_ratio",
    "prefix_cow_copies", "prefix_shared_attaches",
    "prefix_parity", "prefix_chunked_prefill_parity",
    "prefix_dense_prefill_parity",
    "prefix_stall_p95_ms_chunked", "prefix_stall_p95_ms_dense",
)
# ``partition_all_reduce`` is deliberately not required positive: the
# "tp" profile is column-parallel only, which is how exact parity is kept
REQUIRED_PARTITION_ROWS = (
    "tp1_decode_tok_s", "tp2_decode_tok_s",
    "tp2_matches_tp1",
    "kv_bytes_per_device_tp1", "kv_bytes_per_device_tp2",
    "kv_bytes_per_device_ratio",
    "partition_all_gather", "partition_params_sharded",
)
# rows that must be exactly 1, by CLI section
ONE_ROWS = {
    "serving": ("donated_matches_lockstep", "continuous_matches_alone"),
    "paged": ("paged_matches_continuous",),
    "server": ("server_matches_engine", "server_drain_clean"),
    "kernels": ("matmul_reresolve_sweep_free", "matmul_refused_ok"),
    "faults": ("faults_dispatch_contained", "faults_pages_reclaimed",
               "faults_uninjected_parity"),
    "prefix": ("prefix_parity", "prefix_chunked_prefill_parity",
               "prefix_dense_prefill_parity"),
    "partition": ("tp2_matches_tp1",),
}
LAUNCH_PREFIX, REFUSAL_PREFIX = "launches_", "rejected_"


def harness():
    """``scripts/torch_bench.py`` as a module."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_bench
    return torch_bench


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def snapshot(sections, out_path: str, device: str = "cuda",
             reduced: bool = False, layers=None, csv=None) -> dict:
    """Run ``sections`` at the given width and depth and write the rows;
    the CSV lines go to ``csv`` (a file) when given, else to stdout."""
    bench = harness()
    run = bench.configure(device, reduced, layers)
    unknown = [s for s in sections if s not in bench.SECTIONS]
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; "
                         f"available: {sorted(bench.SECTIONS)}")
    bench.ROWS.clear()
    stats = {}
    with (contextlib.redirect_stdout(csv) if csv is not None
          else contextlib.nullcontext()):
        bench.run_sections(list(sections), stats)
    cfg = bench._cfg()
    doc = {
        "schema_version": SCHEMA_VERSION,
        "sections": list(sections),
        "commit": _git_rev(),
        "device": card_name() if device == "cuda" else "cpu",
        "model": {"name": cfg.name, "reduced": run.reduced,
                  "layers": cfg.n_layers, "d_model": cfg.d_model,
                  "compute_dtype": cfg.compute_dtype},
        "section_stats": stats,
        "rows": list(bench.ROWS),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(f"wrote {out_path}: {len(doc['rows'])} rows "
          f"from sections {list(sections)}")
    return doc


def _git_rev() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            text=True, stderr=subprocess.DEVNULL).strip()
    except Exception:
        return "unknown"


ROW_REQUIRED_KEYS = ("section", "name", "value", "unit")
TOP_REQUIRED_KEYS = ("schema_version", "sections", "rows", "device")


def check(path: str) -> int:
    """Validate a snapshot; every problem is one readable line."""
    errors = []
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        errors.append(f"no such file: {path}")
        doc = {}
    except json.JSONDecodeError as exc:
        errors.append(f"not valid JSON: {exc}")
        doc = {}
    if not isinstance(doc, dict):
        errors.append(f"top level must be an object, "
                      f"got {type(doc).__name__}")
        doc = {}
    missing_top = [k for k in TOP_REQUIRED_KEYS if k not in doc]
    if missing_top:
        errors.append(f"missing top-level keys {missing_top}; "
                      f"present: {sorted(doc)}")
    if "schema_version" in doc and doc["schema_version"] != SCHEMA_VERSION:
        errors.append(f"schema_version {doc['schema_version']!r} != "
                      f"{SCHEMA_VERSION}")
    rows = doc.get("rows")
    if rows is not None and (not isinstance(rows, list) or not rows):
        errors.append("rows must be a non-empty list")
        rows = None
    rows = rows or []
    by_name = {}
    for i, r in enumerate(rows):
        if not isinstance(r, dict):
            errors.append(f"rows[{i}] must be an object with keys "
                          f"{list(ROW_REQUIRED_KEYS)}, "
                          f"got {type(r).__name__}: {r!r}")
            continue
        missing = [k for k in ROW_REQUIRED_KEYS if k not in r]
        if missing:
            errors.append(f"rows[{i}] missing keys {missing}; "
                          f"present: {sorted(r)}")
            continue
        by_name[(r["section"], r["name"])] = r["value"]
    sections = doc.get("sections")
    sections = sections if isinstance(sections, list) else []

    def number(label, v):
        try:
            return float(v)
        except (TypeError, ValueError):
            errors.append(f"{label} not numeric: {v!r}")
            return None

    def require(section_label, bench_section, names):
        present = sorted(n for s, n in by_name if s == bench_section)
        out = {}
        for name in names:
            v = by_name.get((bench_section, name))
            if v is None:
                errors.append(f"{section_label} row missing: {name!r} "
                              f"({bench_section} rows present: {present})")
                continue
            fv = number(f"{section_label} row {name}", v)
            if fv is None:
                continue
            if fv <= 0:
                errors.append(f"{section_label} row {name} "
                              f"not positive: {v}")
            out[name] = fv
        return out

    vals = {}
    if "serving" in sections:
        vals["serving"] = require("serving", "E10_serving",
                                  REQUIRED_SERVING_ROWS)
    if "paged" in sections:
        v = vals["paged"] = require("paged", "E12_paged",
                                    REQUIRED_PAGED_ROWS)
        ratio = v.get("paged_kv_bytes_ratio")
        if ratio is not None and ratio >= 1.0:
            errors.append(f"paged row paged_kv_bytes_ratio must be < 1 "
                          f"(paged reserves fewer KV bytes per active "
                          f"token than fixed rows), got {ratio}")
    if "server" in sections:
        v = vals["server"] = require("server", "E13_server",
                                     REQUIRED_SERVER_ROWS)
        clients, slots = v.get("server_clients"), v.get("server_slots")
        if clients is not None and slots is not None and clients <= slots:
            errors.append(f"server section must over-subscribe the engine "
                          f"(clients {clients} <= slots {slots})")
    if "kernels" in sections:
        vals["kernels"] = require("kernels", "E14_kernels",
                                  REQUIRED_KERNELS_ROWS)
        for (s, name), v in sorted(by_name.items()):
            if s == "E14_kernels" and \
                    name.endswith("_selected_over_unfused"):
                ratio = number(f"kernels row {name}", v)
                if ratio is not None and ratio > 1.0:
                    errors.append(
                        f"kernels row {name} must be <= 1 (the "
                        f"autotune-selected config cannot lose to the "
                        f"unfused baseline), got {ratio}")
    if "faults" in sections:
        vals["faults"] = require("faults", "E15_faults",
                                 REQUIRED_FAULTS_ROWS)
    if "prefix" in sections:
        v = vals["prefix"] = require("prefix", "E16_prefix",
                                     REQUIRED_PREFIX_ROWS)
        ratio = v.get("prefix_kv_bytes_ratio")
        if ratio is not None and ratio > 0.6:
            errors.append(f"prefix row prefix_kv_bytes_ratio must be "
                          f"<= 0.6 (the shared-system-prompt workload "
                          f"collapses KV bytes per active token), "
                          f"got {ratio}")
        cow = v.get("prefix_cow_copies")
        if cow is not None and cow < 1:
            errors.append(f"prefix row prefix_cow_copies must be >= 1 "
                          f"(the workload must exercise a copy-on-write), "
                          f"got {cow}")
    if "partition" in sections:
        v = vals["partition"] = require("partition", "E17_partition",
                                        REQUIRED_PARTITION_ROWS)
        ratio = v.get("kv_bytes_per_device_ratio")
        if ratio is not None and ratio > 0.5:
            errors.append(f"partition row kv_bytes_per_device_ratio must "
                          f"be <= 0.5 (each device holds n_kv_heads/tp "
                          f"heads of every KV page), got {ratio}")
    for cli, names in ONE_ROWS.items():
        for name in names:
            got = vals.get(cli, {}).get(name)
            if got is not None and got != 1:
                errors.append(f"{cli} row {name} must be 1, got {got}")

    device = doc.get("device")
    if isinstance(device, str) and device != "cpu":
        _check_card_rows(by_name, sections, device, errors, number)

    if errors:
        for e in errors:
            print(f"CHECK FAIL: {e}", file=sys.stderr)
        return 1
    print(f"{path}: ok ({len(rows)} rows, device {doc.get('device')!r}, "
          f"commit {doc.get('commit')})")
    return 0


def _check_card_rows(by_name, sections, device, errors, number) -> None:
    """On a card every section that reports kernel rows launched some
    kernel and had none refused, and E6 launched the flash kernel."""
    labels = sorted({s for s, n in by_name
                     if n.startswith((LAUNCH_PREFIX, REFUSAL_PREFIX))})
    for label in labels:
        launched = refused = 0.0
        for (s, name), v in by_name.items():
            if s != label:
                continue
            if name.startswith(LAUNCH_PREFIX):
                launched += number(f"{label} row {name}", v) or 0.0
            elif name.startswith(REFUSAL_PREFIX):
                got = number(f"{label} row {name}", v) or 0.0
                if got > 0:
                    errors.append(f"{label} row {name} must be 0 on the "
                                  f"card ({device}), got {v}")
        if launched <= 0:
            errors.append(f"{label}: no kernel launched on the card "
                          f"({device}): its launches_* rows sum to "
                          f"{launched}")
    if "compounding" in sections:
        v = by_name.get(("E6_compound", "flash_launches"))
        if v is None:
            errors.append(f"compounding row missing on the card ({device}): "
                          f"'flash_launches'")
        elif (number("compounding row flash_launches", v) or 0) < 1:
            errors.append(f"compounding row flash_launches must be >= 1 on "
                          f"the card ({device}), got {v}")


def check_autotune_dir(tune_dir: str) -> int:
    """Validate every tuning record under ``tune_dir`` (the cache's
    ``autotune/`` directory, or any directory of ``*.tune.json``)."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.backend import autotune

    paths = []
    for dirpath, _, filenames in os.walk(tune_dir):
        paths += [os.path.join(dirpath, f) for f in sorted(filenames)
                  if f.endswith(".tune.json")]
    errors = []
    for p in paths:
        try:
            with open(p) as fh:
                rec = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            errors.append(f"{p}: unreadable: {exc}")
            continue
        errors += [f"{p}: {e}" for e in autotune.validate_record(rec)]
    if errors:
        for e in errors:
            print(f"CHECK FAIL: {e}", file=sys.stderr)
        return 1
    print(f"{tune_dir}: {len(paths)} autotune records ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sections", nargs="+",
                    default=["serving", "paged", "server", "kernels",
                             "faults", "prefix", "partition"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--check", metavar="FILE",
                    help="validate an existing snapshot instead of running")
    ap.add_argument("--autotune-dir", metavar="DIR",
                    help="with --check: also validate autotune records "
                         "under DIR (missing DIR = nothing to validate)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the sections run (default: the card)")
    ap.add_argument("--reduced", action="store_true",
                    help="deepseek-7b .reduced(), as the reference runs")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of the model sections (default: "
                         "torch_bench's)")
    args = ap.parse_args(argv)
    if args.check:
        rc = check(args.check)
        if args.autotune_dir and os.path.isdir(args.autotune_dir):
            rc = check_autotune_dir(args.autotune_dir) or rc
        return rc
    snapshot(args.sections, args.out, args.device, args.reduced, args.layers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
