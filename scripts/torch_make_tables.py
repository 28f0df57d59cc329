"""Render the dry run's tables from ``results/dryrun_torch`` (the port of
``scripts/make_tables.py``; reads JSON only, imports nothing of either
package).

``python scripts/torch_make_tables.py [all|roofline|dryrun]`` prints the
roofline table of the ``hgx32x8`` mesh and the dry-run table of
``hgx2x32x8`` from the records ``python -m repro_torch.launch.dryrun``
writes (``--out-dir DIR`` reads them from DIR instead).

``python scripts/torch_make_tables.py perf CELL LABEL=DIR [LABEL=DIR ...]``
compares one cell (``<arch>__<shape>``) across the record directories
named on the command line, each a dry run's ``--out-dir`` or one of its
mesh directories: the reference's hard-coded ``results/perf/iter*`` runs
do not exist here.

A key a record lacks prints as ``n/a``; nothing is filled in.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(REPO, "results", "dryrun_torch")
NA = "n/a"


def _num(r: dict, key: str, spec: str, unit: str = "") -> str:
    v = r.get(key)
    return NA if v is None else f"{v:{spec}}{unit}"


def _gib(r: dict) -> str:
    v = r.get("per_device_memory_bytes")
    return NA if v is None else f"{v / 2**30:.1f}"


def load(mesh: str, base: str = DEFAULT_DIR) -> Dict[str, dict]:
    out = {}
    mdir = os.path.join(base, mesh)
    if not os.path.isdir(mdir):
        return out
    for f in sorted(os.listdir(mdir)):
        if f.endswith(".json"):
            with open(os.path.join(mdir, f)) as fh:
                out[f[:-5]] = json.load(fh)
    return out


def roofline_table(mesh: str = "hgx32x8", base: str = DEFAULT_DIR) -> None:
    rows = load(mesh, base)
    n = next(iter(rows.values())).get("n_devices", NA) if rows else NA
    print(f"\n### Roofline — {mesh} ({n} H100s)\n")
    print("| arch | shape | t_compute | t_memory | t_collective | bottleneck "
          "| useful-FLOPs | roofline | mem/dev GiB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for k, r in rows.items():
        arch, shape = k.split("__")
        print(f"| {arch} | {shape} | {_num(r, 't_compute_s', '.3g', 's')} "
              f"| {_num(r, 't_memory_s', '.3g', 's')} "
              f"| {_num(r, 't_collective_s', '.3g', 's')} "
              f"| {r.get('bottleneck', NA)} "
              f"| {_num(r, 'useful_flops_ratio', '.2f')} "
              f"| **{_num(r, 'roofline_fraction', '.3g')}** | {_gib(r)} |")


def dryrun_table(mesh: str = "hgx2x32x8", base: str = DEFAULT_DIR) -> None:
    rows = load(mesh, base)
    print(f"\n### Dry-run — {mesh}\n")
    print("| arch | shape | compile s | params | flops/dev | "
          "collectives (scan-scaled) | mem/dev GiB |")
    print("|---|---|---|---|---|---|---|")
    for k, r in rows.items():
        arch, shape = k.split("__")
        counts = r.get("collective_counts")
        colls = NA if counts is None else ", ".join(
            f"{kk}:{vv}" for kk, vv in sorted(counts.items())) or "—"
        params = r.get("n_params")
        print(f"| {arch} | {shape} | {r.get('compile_s', NA)} | "
              f"{NA if params is None else f'{params / 1e9:.1f}B'} | "
              f"{_num(r, 'hlo_flops_per_dev', '.2e')} | {colls} | "
              f"{_gib(r)} |")


def _record(cell: str, d: str) -> Optional[dict]:
    for path in (os.path.join(d, f"{cell}.json"),
                 os.path.join(d, "hgx32x8", f"{cell}.json")):
        if os.path.exists(path):
            with open(path) as fh:
                return json.load(fh)
    return None


def perf_compare(cell: str, runs: List[Tuple[str, str]]) -> None:
    """runs: (label, record directory) pairs."""
    print(f"\n### {cell}\n")
    print("| version | t_compute | t_memory | t_collective | bottleneck | "
          "roofline | mem/dev GiB |")
    print("|---|---|---|---|---|---|---|")
    for label, d in runs:
        r = _record(cell, d)
        if r is None:
            print(f"| {label} | {NA} | {NA} | {NA} | {NA} | {NA} | {NA} |")
            continue
        print(f"| {label} | {_num(r, 't_compute_s', '.3g', 's')} "
              f"| {_num(r, 't_memory_s', '.3g', 's')} "
              f"| {_num(r, 't_collective_s', '.3g', 's')} "
              f"| {r.get('bottleneck', NA)} "
              f"| **{_num(r, 'roofline_fraction', '.3g')}** | {_gib(r)} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all", "roofline", "dryrun", "perf"))
    ap.add_argument("runs", nargs="*",
                    help="perf: CELL, then LABEL=DIR for each run")
    ap.add_argument("--out-dir", default=DEFAULT_DIR,
                    help="the dry run's record directory")
    args = ap.parse_args(argv)
    if args.which in ("all", "roofline"):
        roofline_table("hgx32x8", args.out_dir)
    if args.which in ("all", "dryrun"):
        dryrun_table("hgx2x32x8", args.out_dir)
    if args.which == "perf":
        if len(args.runs) < 2 or any("=" not in r for r in args.runs[1:]):
            ap.error("perf takes CELL LABEL=DIR [LABEL=DIR ...]")
        perf_compare(args.runs[0],
                     [tuple(r.split("=", 1)) for r in args.runs[1:]])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
