"""DiskCompileCache: the persistence layer under the in-memory compile cache.

A compile whose options are process-stable (no opaque meshes/shardings/
plans — see ``CompileOptions.stable_token``) is written to disk keyed on
the canonical graph signature + parameter names + resolved level + options
+ backend name/opts (the torch backend adds its device's name) + the
port's identity (:func:`_versions`: the repro_torch and torch versions,
the CUDA version, and a hash of the kernels' sources and build script),
so a *cold process* that rebuilds a structurally-identical graph skips the
pass pipeline entirely: the entry stores the serialized *optimized* graph
(``core.serialize``), the :class:`PipelineReport`, the memory-plan totals
and the cost estimate.  The port has no executable format: a hit runs
code generation again (and, on the card, the capture).  A change in any
identity item changes every key, which is the invalidation story: stale
entries stop being addressed and age out via eviction.

Robustness contract (tested in ``tests/test_torch_diskcache.py``):

  * writes go to a temp file in the same directory and are published with
    ``os.replace`` — concurrent processes racing on one key cannot clobber
    each other or expose a torn entry;
  * a corrupt/truncated/alien entry is *skipped and evicted*, never
    allowed to fail a compile;
  * total entry bytes are kept under ``budget_bytes`` by LRU eviction
    (hits refresh an entry's mtime, eviction removes oldest-mtime first).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..core import serialize
from ..core.function import Function
from ..core.passes.base import PipelineReport

ENTRY_FORMAT = 1
ENTRY_SUFFIX = ".entry.json"
TUNE_DIR = "autotune"

# defaults, overridable per-options and by environment (CI convenience:
# exporting REPRO_CACHE_DIR turns the cache on for every compile in the
# process without touching call sites)
ENV_DIR = "REPRO_CACHE_DIR"
ENV_BUDGET = "REPRO_CACHE_BUDGET_BYTES"
DEFAULT_BUDGET_BYTES = 1 << 30  # 1 GiB


def resolve_dir(options) -> Optional[str]:
    """The cache root for ``options``: explicit field, else environment."""
    root = options.cache_dir
    if root is None:
        root = os.environ.get(ENV_DIR) or None
    # a '~/...' from a config file or .env never saw the shell — expanding
    # here keeps it from becoming a literal './~' directory
    return os.path.expanduser(root) if root else None


def resolve_budget(options=None) -> int:
    """Byte budget: explicit option, else environment, else the default
    (options=None resolves environment/default only — cache_tool.py)."""
    if options is not None and options.cache_budget_bytes is not None:
        return options.cache_budget_bytes
    env = os.environ.get(ENV_BUDGET)
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    return DEFAULT_BUDGET_BYTES


@functools.lru_cache(maxsize=1)
def _kernel_hash() -> str:
    """sha256 over the kernels' CUDA sources and their build script: a
    kernel edit changes what an entry's program launches."""
    kdir = Path(__file__).resolve().parents[1] / "kernels"
    h = hashlib.sha256()
    for p in sorted((kdir / "csrc").iterdir()) + [kdir / "_build.py"]:
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _versions() -> Dict[str, str]:
    import torch

    import repro_torch
    return {"repro_torch": repro_torch.__version__,
            "torch": torch.__version__,
            "cuda": torch.version.cuda or "cpu",
            "kernels": _kernel_hash()}


def device_name(device) -> str:
    """The name an entry is keyed on for ``device`` (a ``torch.device``):
    the card's product name, or ``"cpu"``."""
    import torch
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def entry_key(signature: str, param_names: Tuple[str, ...], level: str,
              options, backend_name: str,
              backend_opts: Optional[Dict] = None) -> Optional[str]:
    """Hex digest addressing one executable on disk, or None if the
    options aren't process-stable (opaque mesh/sharding/plan objects)."""
    tok = options.stable_token()
    if tok is None:
        return None
    from .options import _stable_token, _UNSTABLE
    opts_tok = _stable_token(tuple(sorted((backend_opts or {}).items())))
    if opts_tok is _UNSTABLE:
        return None
    doc = ("repro-diskcache-v%d" % ENTRY_FORMAT, signature,
           tuple(param_names), level, backend_name, opts_tok, tok,
           tuple(sorted(_versions().items())))
    return hashlib.sha256(repr(doc).encode()).hexdigest()


@dataclasses.dataclass
class DiskStats:
    entries: int
    total_bytes: int
    budget_bytes: int
    hits: int
    misses: int
    evictions: int


class DiskCompileCache:
    """One on-disk cache root; safe for many processes to share."""

    def __init__(self, root: str, budget_bytes: int = DEFAULT_BUDGET_BYTES):
        self.root = root
        self.budget_bytes = int(budget_bytes)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        os.makedirs(root, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _entry_path(self, key: str) -> str:
        return os.path.join(self.root, key + ENTRY_SUFFIX)

    def entry_paths(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(os.path.join(self.root, n) for n in names
                      if n.endswith(ENTRY_SUFFIX))

    # -- load ----------------------------------------------------------------
    def load(self, key: str) -> Optional[Dict]:
        """The decoded entry for ``key``, or None (miss / corrupt).

        Corrupt entries are evicted on the spot: a broken file must never
        be able to fail a compile, and leaving it would make every future
        lookup of its key re-pay the failed parse."""
        path = self._entry_path(key)
        try:
            with open(path) as fh:
                entry = json.load(fh)
            if entry.get("format") != ENTRY_FORMAT:
                raise ValueError(f"format {entry.get('format')!r}")
            if entry.get("serialize_format") != serialize.FORMAT_VERSION:
                raise ValueError(
                    f"serialize format {entry.get('serialize_format')!r}")
            # decode up front so a truncated graph doc is caught *here*
            fn = serialize.from_doc(entry["function"])
            report = PipelineReport(
                stats=[(name, dict(st)) for name, st in entry["report"]["stats"]],
                nodes_before=int(entry["report"]["nodes_before"]),
                nodes_after=int(entry["report"]["nodes_after"]),
                seconds=float(entry["report"]["seconds"]))
            entry["function"] = fn
            entry["report"] = report
        except FileNotFoundError:
            self.misses += 1
            return None
        except Exception:
            self._remove(path)
            self.evictions += 1
            self.misses += 1
            return None
        self.hits += 1
        try:
            os.utime(path)  # LRU touch: a hit is a use
        except OSError:
            pass
        return entry

    # -- store ---------------------------------------------------------------
    def store(self, key: str, *, fn: Function, report: PipelineReport,
              level: str, backend_name: str, options,
              memory_plan=None, cost=None) -> None:
        """Serialize one compiled artifact; best-effort (persistence
        failures — I/O, an unserializable graph attr — are the caller's
        compile succeeding without persistence, not failing)."""
        try:
            self._store(key, fn=fn, report=report, level=level,
                        backend_name=backend_name, options=options,
                        memory_plan=memory_plan, cost=cost)
        except Exception:
            return
        self.evict(self.budget_bytes)

    def _store(self, key: str, *, fn: Function, report: PipelineReport,
               level: str, backend_name: str, options,
               memory_plan=None, cost=None) -> None:
        entry = {
            "format": ENTRY_FORMAT,
            "key": key,
            "backend": backend_name,
            "level": level,
            "param_names": [p.name for p in fn.parameters],
            "options": _options_doc(options),
            "versions": _versions(),
            "serialize_format": serialize.FORMAT_VERSION,
            "function": serialize.to_doc(fn),
            "report": {
                "stats": [[name, st] for name, st in report.stats],
                "nodes_before": report.nodes_before,
                "nodes_after": report.nodes_after,
                "seconds": report.seconds,
            },
            "memory_plan": None if memory_plan is None else {
                "arena_bytes": memory_plan.arena_bytes,
                "naive_bytes": memory_plan.naive_bytes,
                "peak_live_bytes": memory_plan.peak_live_bytes,
                "io_bytes": memory_plan.io_bytes,
            },
            "cost": None if cost is None else {
                "flops": cost.flops,
                "bytes": cost.bytes,
                "by_op": cost.by_op,
            },
        }
        self._atomic_write(self._entry_path(key),
                           json.dumps(entry, sort_keys=True))

    def _atomic_write(self, path: str, text: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(text)
            os.replace(tmp, path)
        except BaseException:
            self._remove(tmp)
            raise

    # -- eviction ------------------------------------------------------------
    #: a .tmp older than this is an orphan from a killed writer, not a
    #: write in progress — os.replace publishes within milliseconds
    STALE_TMP_SECONDS = 3600

    def _reap_stale_tmp(self) -> None:
        """Remove orphaned temp files (a writer killed between mkstemp and
        os.replace leaves one behind; entry_paths/stats never see them, so
        without this they'd accumulate invisibly forever)."""
        cutoff = time.time() - self.STALE_TMP_SECONDS
        for d in (self.root, os.path.join(self.root, TUNE_DIR)):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for n in names:
                if not n.endswith(".tmp"):
                    continue
                p = os.path.join(d, n)
                try:
                    if os.stat(p).st_mtime < cutoff:
                        self._remove(p)
                except OSError:
                    pass

    def evict(self, budget_bytes: Optional[int] = None) -> int:
        """Delete oldest-mtime entries until total size <= budget.

        Returns the number of entries removed."""
        self._reap_stale_tmp()
        budget = self.budget_bytes if budget_bytes is None else budget_bytes
        infos = []
        for p in self.entry_paths():
            try:
                st = os.stat(p)
            except OSError:
                continue
            infos.append((st.st_mtime, st.st_size, p))
        total = sum(sz for _, sz, _ in infos)
        removed = 0
        for _, sz, p in sorted(infos):
            if total <= budget:
                break
            if self._remove(p):
                total -= sz
                removed += 1
                self.evictions += 1
        return removed

    def clear(self) -> int:
        n = 0
        for p in self.entry_paths():
            n += self._remove(p)
        tdir = os.path.join(self.root, TUNE_DIR)
        if os.path.isdir(tdir):
            for name in os.listdir(tdir):
                self._remove(os.path.join(tdir, name))
        return n

    @staticmethod
    def _remove(path: str) -> bool:
        try:
            os.remove(path)
            return True
        except OSError:
            return False

    # -- introspection -------------------------------------------------------
    def stats(self) -> DiskStats:
        sizes = []
        for p in self.entry_paths():
            try:
                sizes.append(os.stat(p).st_size)
            except OSError:
                pass
        return DiskStats(entries=len(sizes), total_bytes=sum(sizes),
                         budget_bytes=self.budget_bytes, hits=self.hits,
                         misses=self.misses, evictions=self.evictions)

    # -- tuning records (see repro_torch.backend.autotune) -------------------
    def tune_path(self, key: str) -> str:
        return os.path.join(self.root, TUNE_DIR, key + ".tune.json")

    def load_tuning(self, key: str) -> Optional[Dict]:
        try:
            with open(self.tune_path(key)) as fh:
                rec = json.load(fh)
            if rec.get("format") != ENTRY_FORMAT:
                raise ValueError(f"format {rec.get('format')!r}")
            return rec
        except FileNotFoundError:
            return None
        except Exception:
            # torn write / stale format: evict like corrupt compile
            # entries so the next sweep can re-record cleanly
            self.remove_tuning(key)
            return None

    def remove_tuning(self, key: str) -> bool:
        """Evict one tuning record (corrupt or invalidated)."""
        removed = self._remove(self.tune_path(key))
        if removed:
            self.evictions += 1
        return removed

    def store_tuning(self, key: str, record: Dict) -> None:
        try:
            os.makedirs(os.path.join(self.root, TUNE_DIR), exist_ok=True)
            self._atomic_write(self.tune_path(key),
                               json.dumps(record, sort_keys=True))
        except Exception:
            pass


def _options_doc(options) -> Dict[str, Any]:
    """The stable option fields, for entry introspection (cache_tool ls)."""
    out = {}
    for f in dataclasses.fields(options):
        v = getattr(options, f.name)
        if v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        elif isinstance(v, (tuple, list)):
            out[f.name] = list(v)
        else:
            out[f.name] = repr(v)
    return out
