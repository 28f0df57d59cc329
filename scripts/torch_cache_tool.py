#!/usr/bin/env python3
"""Inspect/maintain the torch port's persistent compile cache
(repro_torch.backend.diskcache); imports only ``repro_torch``.

Used locally and in CI logs to see what the cache holds and why a run was
(or wasn't) a warm start.

  python scripts/torch_cache_tool.py ls     [--dir DIR]  entries + tuning records
  python scripts/torch_cache_tool.py stats  [--dir DIR]  totals vs budget
  python scripts/torch_cache_tool.py prune  [--dir DIR] [--budget BYTES]
  python scripts/torch_cache_tool.py clear  [--dir DIR]

--dir defaults to $REPRO_CACHE_DIR.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.backend import diskcache  # noqa: E402


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _age(mtime: float) -> str:
    s = max(time.time() - mtime, 0)
    if s < 120:
        return f"{s:.0f}s"
    if s < 7200:
        return f"{s / 60:.0f}m"
    return f"{s / 3600:.1f}h"


def _tune_paths(cache: diskcache.DiskCompileCache):
    tdir = os.path.join(cache.root, diskcache.TUNE_DIR)
    if not os.path.isdir(tdir):
        return []
    return sorted(os.path.join(tdir, n) for n in os.listdir(tdir)
                  if n.endswith(".tune.json"))


def cmd_ls(cache: diskcache.DiskCompileCache) -> int:
    rows = 0
    for p in cache.entry_paths():
        try:
            st = os.stat(p)
        except OSError:
            continue  # evicted by a live process between listdir and stat
        try:
            with open(p) as fh:
                e = json.load(fh)
            opts = e.get("options", {})
            vs = e.get("versions", {})
            desc = (f"backend={e.get('backend')} level={e.get('level')} "
                    f"nodes={e.get('report', {}).get('nodes_after', '?')} "
                    f"params={len(e.get('param_names', []))} "
                    f"attn={opts.get('attn_impl')}/{opts.get('attn_chunk')} "
                    f"torch={vs.get('torch')} cuda={vs.get('cuda')} "
                    f"kernels={str(vs.get('kernels'))[:12]} "
                    f"repro_torch={vs.get('repro_torch')}")
        except Exception as exc:
            desc = f"CORRUPT ({type(exc).__name__}) — will be evicted on load"
        key = os.path.basename(p)[:12]
        print(f"{key}  {_fmt_bytes(st.st_size):>10}  {_age(st.st_mtime):>6}  "
              f"{desc}")
        rows += 1
    for p in _tune_paths(cache):
        try:
            st = os.stat(p)
        except OSError:
            continue
        try:
            with open(p) as fh:
                r = json.load(fh)
            w = r.get("winner", {})
            desc = (f"autotune backend={r.get('backend')} winner="
                    f"{w.get('attn_impl')}/{w.get('attn_chunk')}"
                    f"{'+pallas' if w.get('use_pallas') else ''} "
                    f"({len(r.get('candidates', []))} candidates timed)")
        except Exception as exc:
            desc = f"CORRUPT tuning record ({type(exc).__name__})"
        key = os.path.basename(p)[:12]
        print(f"{key}  {_fmt_bytes(st.st_size):>10}  {_age(st.st_mtime):>6}  "
              f"{desc}")
        rows += 1
    if not rows:
        print(f"(empty cache at {cache.root})")
    return 0


def cmd_stats(cache: diskcache.DiskCompileCache) -> int:
    st = cache.stats()
    tunes = _tune_paths(cache)
    tune_bytes = 0
    for p in tunes:
        try:
            tune_bytes += os.stat(p).st_size
        except OSError:
            pass
    print(f"dir:              {cache.root}")
    print(f"entries:          {st.entries} ({_fmt_bytes(st.total_bytes)})")
    print(f"tuning records:   {len(tunes)} ({_fmt_bytes(tune_bytes)})")
    print(f"budget:           {_fmt_bytes(st.budget_bytes)} "
          f"({st.total_bytes / max(st.budget_bytes, 1) * 100:.1f}% used)")
    return 0


def cmd_prune(cache: diskcache.DiskCompileCache, budget: int) -> int:
    removed = cache.evict(budget)
    st = cache.stats()
    print(f"pruned {removed} entries; {st.entries} remain "
          f"({_fmt_bytes(st.total_bytes)} <= {_fmt_bytes(budget)})")
    return 0


def cmd_clear(cache: diskcache.DiskCompileCache) -> int:
    n = cache.clear()
    print(f"cleared {n} entries (+ tuning records) from {cache.root}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("command", choices=("ls", "stats", "prune", "clear"))
    ap.add_argument("--dir", default=os.environ.get(diskcache.ENV_DIR),
                    help="cache root (default: $REPRO_CACHE_DIR)")
    ap.add_argument("--budget", type=int, default=diskcache.resolve_budget(),
                    help="byte budget for prune (default: "
                         "$REPRO_CACHE_BUDGET_BYTES, else 1 GiB)")
    args = ap.parse_args(argv)
    if not args.dir:
        print("no cache dir: pass --dir or set $REPRO_CACHE_DIR",
              file=sys.stderr)
        return 2
    cache = diskcache.DiskCompileCache(os.path.expanduser(args.dir),
                                       args.budget)
    return {"ls": cmd_ls, "stats": cmd_stats, "clear": cmd_clear,
            "prune": lambda c: cmd_prune(c, args.budget)}[args.command](cache)


if __name__ == "__main__":
    raise SystemExit(main())
