"""The persistent on-disk compile cache on torch: every case of
``tests/test_diskcache.py`` on the port's ``"torch"`` backend (on the CPU)
and on its numpy ``"interpreter"`` -- cold-process warm starts, corruption
robustness, atomic concurrent writes, LRU byte-budget eviction and
invalidation -- plus the port's own identity: its version, the torch
version, the CUDA version, the kernels' source hash and (on the torch
backend) the device's name each address a new entry.  A disk hit's
outputs are held against the JAX package's backend on the same numpy
inputs (1e-4 of scale in f32).
"""
import hashlib
import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import Backend as JBackend  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402

import repro_torch  # noqa: E402
import repro_torch.backend.base as backend_base  # noqa: E402
from repro_torch.backend import Backend, CompileOptions  # noqa: E402
from repro_torch.backend import DiskCompileCache, diskcache  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.function import Function  # noqa: E402

BACKENDS = {"interpreter": ("interpreter", {}, "O0"),
            "torch": ("torch", {"device": "cpu"}, "O1")}


def _graph(scale=1.0, ops=ops, Function=Function):
    x = ops.parameter((4, 16), "f32", "x")
    w = ops.parameter((16,), "f32", "w")
    y = ops.softmax(ops.rms_norm(ops.gelu(x.out() * scale), w.out()), -1)
    return Function([x, w], [y])


def _args():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(4, 16)).astype(np.float32),
            np.ones(16, np.float32)]


def _jax_ref():
    return JBackend.create("jax").compile(
        _graph(ops=j_ops, Function=JFunction))(*_args())[0]


def _close(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(ref.astype(np.float64) - got).max()) <= 1e-4 * scale


@pytest.fixture(params=sorted(BACKENDS))
def backend_name(request):
    return request.param


def _fresh(name):
    reg, kw, _ = BACKENDS[name]
    return Backend.create(reg, fresh=True, **kw)


def test_cold_process_is_a_disk_hit(tmp_path, monkeypatch, backend_name):
    """A fresh backend (= cold process) over the same cache dir rehydrates
    from disk: the pass pipeline must NOT re-run, the PipelineReport is
    the stored one, and the executable still computes + binds by name."""
    opts = CompileOptions(cache_dir=str(tmp_path))
    be1 = _fresh(backend_name)
    cf1 = be1.compile(_graph(), opts)
    out1 = cf1(*_args())
    st1 = be1.cache_stats()
    assert st1.disk_misses == 1 and st1.disk_hits == 0
    assert not cf1.from_disk

    be2 = _fresh(backend_name)

    def boom(*a, **k):
        raise AssertionError("pass pipeline re-ran on a disk hit")

    monkeypatch.setattr(backend_base, "run_pipeline", boom)
    cf2 = be2.compile(_graph(), opts)  # independently rebuilt graph
    st2 = be2.cache_stats()
    assert st2.disk_hits == 1 and st2.disk_misses == 0
    assert cf2.from_disk
    # the stored report, plan, and cost came back, not recomputed
    assert cf2.report.nodes_after == cf1.report.nodes_after
    assert [n for n, _ in cf2.report.stats] == [n for n, _ in cf1.report.stats]
    assert cf2.memory_plan.arena_bytes == cf1.memory_plan.arena_bytes
    assert cf2.cost.flops == cf1.cost.flops
    a = _args()
    np.testing.assert_allclose(cf2(*a)[0], out1[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cf2(x=a[0], w=a[1])[0], out1[0],
                               rtol=1e-5, atol=1e-6)
    _close(_jax_ref(), cf2(*a)[0])


def test_different_options_and_graphs_get_distinct_entries(tmp_path,
                                                           backend_name):
    opts = CompileOptions(cache_dir=str(tmp_path))
    be = _fresh(backend_name)
    be.compile(_graph(), opts)
    be.compile(_graph(scale=2.0), opts)
    be.compile(_graph(), opts.replace(attn_chunk=512))
    dc = DiskCompileCache(str(tmp_path))
    assert dc.stats().entries == 3


def test_opaque_options_are_not_disk_cached(tmp_path, backend_name):
    """Options keyed by object identity can't address disk entries —
    compiles still work, nothing is written."""
    opts = CompileOptions(cache_dir=str(tmp_path), mesh=object())
    be = _fresh(backend_name)
    cf = be.compile(_graph(), opts)
    assert cf(*_args())[0].shape == (4, 16)
    st = be.cache_stats()
    assert st.disk_hits == 0 and st.disk_misses == 0
    assert DiskCompileCache(str(tmp_path)).stats().entries == 0


@pytest.mark.parametrize("corruption", ["garbage", "truncated", "alien"])
def test_corrupt_entry_is_skipped_and_evicted(tmp_path, corruption,
                                              backend_name):
    """A broken entry file must never fail a compile: it is removed, the
    compile falls through to a full build, and a valid entry replaces it."""
    opts = CompileOptions(cache_dir=str(tmp_path))
    be1 = _fresh(backend_name)
    be1.compile(_graph(), opts)
    dc = DiskCompileCache(str(tmp_path))
    [path] = dc.entry_paths()
    with open(path) as fh:
        text = fh.read()
    if corruption == "garbage":
        blob = "NOT JSON {{{"
    elif corruption == "truncated":
        blob = text[: len(text) // 2]
    else:  # valid JSON, wrong shape
        blob = json.dumps({"format": diskcache.ENTRY_FORMAT, "function": {}})
    with open(path, "w") as fh:
        fh.write(blob)

    be2 = _fresh(backend_name)
    cf = be2.compile(_graph(), opts)
    assert cf(*_args())[0].shape == (4, 16)
    st = be2.cache_stats()
    assert st.disk_hits == 0
    assert st.disk_evictions >= 1
    # the rewritten entry is valid again: next cold consumer hits
    be3 = _fresh(backend_name)
    be3.compile(_graph(), opts)
    assert be3.cache_stats().disk_hits == 1


def test_eviction_respects_budget_and_lru_order(tmp_path, backend_name):
    """Oldest-mtime entries go first, and total bytes end <= budget.
    A *hit* refreshes an entry's position (it is recently-used)."""
    opts = CompileOptions(cache_dir=str(tmp_path))
    be = _fresh(backend_name)
    for scale in (1.0, 2.0, 3.0):
        be.compile(_graph(scale=scale), opts)
    dc = DiskCompileCache(str(tmp_path))
    paths = dc.entry_paths()
    assert len(paths) == 3
    # stage deterministic mtimes: paths[0] oldest ... paths[2] newest
    for i, p in enumerate(sorted(paths, key=str)):
        os.utime(p, (1_000_000 + i, 1_000_000 + i))
    by_age = sorted(dc.entry_paths(), key=lambda p: os.stat(p).st_mtime)
    sizes = {p: os.stat(p).st_size for p in by_age}
    budget = sizes[by_age[1]] + sizes[by_age[2]]  # room for exactly two
    removed = dc.evict(budget)
    assert removed == 1
    remaining = dc.entry_paths()
    assert by_age[0] not in remaining
    assert set(remaining) == set(by_age[1:])
    assert sum(os.stat(p).st_size for p in remaining) <= budget
    assert dc.evictions == 1

    # LRU refresh: touch the now-oldest via a load, then evict to one entry
    oldest_key = os.path.basename(by_age[1])[: -len(diskcache.ENTRY_SUFFIX)]
    os.utime(by_age[1], (1_000_001, 1_000_001))
    os.utime(by_age[2], (2_000_000, 2_000_000))
    assert dc.load(oldest_key) is not None  # hit refreshes mtime to "now"
    dc.evict(max(sizes.values()) * 1)
    remaining = dc.entry_paths()
    assert by_age[1] in remaining and by_age[2] not in remaining


def test_store_respects_budget_inline(tmp_path, backend_name):
    """Backend compiles over a tiny budget never leave the dir oversized."""
    opts = CompileOptions(cache_dir=str(tmp_path), cache_budget_bytes=1)
    be = _fresh(backend_name)
    for scale in (1.0, 2.0):
        be.compile(_graph(scale=scale), opts)
    dc = DiskCompileCache(str(tmp_path))
    assert dc.stats().entries == 0  # everything over budget evicted
    assert be.cache_stats().disk_evictions >= 2


def test_concurrent_writers_never_publish_a_torn_entry(tmp_path,
                                                       backend_name):
    """Many threads racing store() on one key: every load() observes a
    complete entry (write-to-temp + atomic rename), never a torn file."""
    reg, _, level = BACKENDS[backend_name]
    opts = CompileOptions(cache_dir=str(tmp_path))
    be = _fresh(backend_name)
    cf = be.compile(_graph(), opts)
    dc = DiskCompileCache(str(tmp_path))
    [path] = dc.entry_paths()
    key = os.path.basename(path)[: -len(diskcache.ENTRY_SUFFIX)]
    stop = threading.Event()
    errors = []

    def writer():
        w = DiskCompileCache(str(tmp_path))
        while not stop.is_set():
            w.store(key, fn=cf.function, report=cf.report, level=level,
                    backend_name=reg, options=opts)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        reader = DiskCompileCache(str(tmp_path))
        for _ in range(200):
            entry = reader.load(key)
            if entry is None:  # a miss is fine; a torn read is not
                continue
            if entry["report"].nodes_after != cf.report.nodes_after:
                errors.append("decoded entry does not match what was stored")
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors
    assert reader.evictions == 0  # nothing was ever seen corrupt
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_version_bump_invalidates_keys(tmp_path, monkeypatch, backend_name):
    """A different repro_torch version addresses different entries: the
    old one is simply never consulted (and ages out via eviction)."""
    opts = CompileOptions(cache_dir=str(tmp_path))
    be1 = _fresh(backend_name)
    be1.compile(_graph(), opts)

    real = diskcache._versions()
    monkeypatch.setattr(diskcache, "_versions",
                        lambda: {**real, "repro_torch": "999.0.0"})
    be2 = _fresh(backend_name)
    be2.compile(_graph(), opts)
    st = be2.cache_stats()
    assert st.disk_hits == 0 and st.disk_misses == 1
    assert DiskCompileCache(str(tmp_path)).stats().entries == 2


def test_env_var_enables_cache(tmp_path, monkeypatch, backend_name):
    monkeypatch.setenv(diskcache.ENV_DIR, str(tmp_path))
    be1 = _fresh(backend_name)
    be1.compile(_graph())  # no cache_dir in options
    be2 = _fresh(backend_name)
    be2.compile(_graph())
    assert be2.cache_stats().disk_hits == 1


def test_clear_cache_keeps_disk_entries(tmp_path, backend_name):
    opts = CompileOptions(cache_dir=str(tmp_path))
    be = _fresh(backend_name)
    be.compile(_graph(), opts)
    be.clear_cache()
    assert be.cache_stats().size == 0
    assert DiskCompileCache(str(tmp_path)).stats().entries == 1  # persists
    be.compile(_graph(), opts)
    assert be.cache_stats().disk_hits == 1


def test_serialize_format_bump_invalidates_entries(tmp_path, monkeypatch,
                                                   backend_name):
    """An entry persisted under an older graph-doc format must never be
    mis-decoded under the new rules: it is rejected (and evicted) on load."""
    from repro_torch.core import serialize
    opts = CompileOptions(cache_dir=str(tmp_path))
    be1 = _fresh(backend_name)
    be1.compile(_graph(), opts)

    monkeypatch.setattr(serialize, "FORMAT_VERSION",
                        serialize.FORMAT_VERSION + 1)
    be2 = _fresh(backend_name)
    cf = be2.compile(_graph(), opts)  # full rebuild, not a mis-decode
    st = be2.cache_stats()
    assert st.disk_hits == 0 and not cf.from_disk
    assert st.disk_evictions == 1  # the stale entry was dropped on sight


def test_tilde_cache_dir_expands_to_home(tmp_path, monkeypatch,
                                         backend_name):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)  # a literal './~' would land here
    be = _fresh(backend_name)
    be.compile(_graph(), CompileOptions(cache_dir="~/repro-cache"))
    assert DiskCompileCache(str(tmp_path / "repro-cache")).stats().entries == 1
    assert not os.path.exists(os.path.join(str(tmp_path), "~"))


def test_stale_tmp_orphans_are_reaped_on_eviction(tmp_path):
    """A writer killed between mkstemp and os.replace leaves a .tmp the
    entry/stats listings never see — eviction must reap old ones (and
    leave fresh ones alone: another process may be mid-write)."""
    cache = DiskCompileCache(str(tmp_path))
    old = tmp_path / "orphan.tmp"
    old.write_text("x" * 100)
    os.utime(old, (0, 0))  # ancient
    fresh = tmp_path / "inflight.tmp"
    fresh.write_text("y")
    cache.evict()
    assert not old.exists()
    assert fresh.exists()


# -- the port's identity ---------------------------------------------------------
def test_versions_name_the_port_torch_cuda_and_kernel_sources():
    vs = diskcache._versions()
    assert vs["repro_torch"] == repro_torch.__version__
    assert vs["torch"] == torch.__version__
    assert vs["cuda"] == (torch.version.cuda or "cpu")
    # the hash covers every kernel source and the build script, by name
    # and content
    kdir = Path(repro_torch.__file__).resolve().parent / "kernels"
    h = hashlib.sha256()
    for p in sorted((kdir / "csrc").iterdir()) + [kdir / "_build.py"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    assert vs["kernels"] == h.hexdigest()
    assert len(list((kdir / "csrc").glob("*.cu"))) >= 5


def _patch_torch_version(mp):
    mp.setattr(torch, "__version__", "0.0.0-other")


def _patch_cuda_version(mp):
    mp.setattr(torch.version, "cuda", "99.9")


def _patch_kernel_hash(mp):
    mp.setattr(diskcache, "_kernel_hash", lambda: "0" * 64)


IDENTITY = {"torch": _patch_torch_version, "cuda": _patch_cuda_version,
            "kernels": _patch_kernel_hash}


@pytest.mark.parametrize("item", sorted(IDENTITY))
def test_each_identity_item_addresses_a_new_entry(tmp_path, monkeypatch,
                                                  backend_name, item):
    """The torch version, the CUDA version and the kernel-source hash each
    change the key: a compile after the change is a disk miss beside the
    old entry, and the old entry still hits once the change is undone."""
    opts = CompileOptions(cache_dir=str(tmp_path))
    _fresh(backend_name).compile(_graph(), opts)
    with monkeypatch.context() as mp:
        IDENTITY[item](mp)
        be = _fresh(backend_name)
        be.compile(_graph(), opts)
        st = be.cache_stats()
        assert st.disk_hits == 0 and st.disk_misses == 1
    assert DiskCompileCache(str(tmp_path)).stats().entries == 2
    be = _fresh(backend_name)
    be.compile(_graph(), opts)
    assert be.cache_stats().disk_hits == 1


def test_device_name_joins_the_torch_key(tmp_path, monkeypatch):
    """Two cards in the same slot ("cuda:0") are different devices to an
    entry: the torch backend keys on the device's product name."""
    be = Backend.create("torch", fresh=True, device="cpu")
    assert be._key_opts() == {"device": "cpu", "device_name": "cpu"}
    opts = CompileOptions(cache_dir=str(tmp_path))
    be.compile(_graph(), opts)
    monkeypatch.setattr(diskcache, "device_name",
                        lambda device: "NVIDIA H100 80GB HBM3")
    be2 = Backend.create("torch", fresh=True, device="cpu")
    assert be2._key_opts()["device_name"] == "NVIDIA H100 80GB HBM3"
    be2.compile(_graph(), opts)
    st = be2.cache_stats()
    assert st.disk_hits == 0 and st.disk_misses == 1
    assert DiskCompileCache(str(tmp_path)).stats().entries == 2


@pytest.mark.cuda
def test_card_entry_hits_and_names_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    be = Backend.create("torch", fresh=True, device="cuda")
    assert be._key_opts()["device_name"] == torch.cuda.get_device_name(0)
    opts = CompileOptions(cache_dir=str(tmp_path))
    out1 = be.compile(_graph(), opts)(*_args())[0]
    be2 = Backend.create("torch", fresh=True, device="cuda")
    cf = be2.compile(_graph(), opts)
    assert cf.from_disk
    for _ in range(3):   # eager first call, capture, replay
        np.testing.assert_array_equal(cf(*_args())[0], out1)
    _close(_jax_ref(), out1)


# -- the engine and the serving CLI ----------------------------------------------
def test_compile_options_folding():
    """EngineConfig's cache/autotune conveniences layer onto an explicit
    options object without clobbering its other fields."""
    from repro_torch.launch.engine import EngineConfig
    c = EngineConfig(cache_dir="/x", cache_budget_bytes=123, autotune=True)
    o = c.compile_options()
    assert (o.cache_dir, o.cache_budget_bytes, o.autotune) == \
        ("/x", 123, True)
    base = CompileOptions(level="O2", static_jit=False)
    o2 = c.compile_options(base)
    assert o2.level == "O2" and not o2.static_jit and o2.cache_dir == "/x"
    # nothing set -> base passes through untouched
    assert EngineConfig().compile_options(base) is base
    with pytest.raises(ValueError, match="cache_budget_bytes"):
        EngineConfig(cache_budget_bytes=0)


def test_serve_cli_warm_run_hits_the_disk_and_sweeps_nothing(
        tmp_path, monkeypatch, capsys):
    """Two runs of the serving CLI over one cache dir, each as a fresh
    process would be (no backend instance carries over): the first
    sweeps and stores, the second takes every graph from disk, re-sweeps
    nothing (``--min-disk-hits``) and serves the same tokens."""
    from repro_torch.launch import serve
    argv = ["--reduced", "--device", "cpu", "--mode", "paged", "--level",
            "O2", "--kernels", "--requests", "2", "--prompt-len", "8",
            "--gen", "4", "--cache-dir", str(tmp_path), "--autotune"]
    outs = []
    for extra in ([], ["--min-disk-hits", "1"]):
        monkeypatch.setattr(Backend, "_INSTANCES", {})
        assert serve.main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    cold, warm = outs
    assert "disk_hits=0" in cold and "autotune_sweeps=0" not in cold
    assert "[disk-cache] ok" in warm and "autotune_sweeps=0" in warm
    toks = [[ln for ln in o.splitlines() if ln.startswith("  req")]
            for o in outs]
    assert toks[0] == toks[1] and toks[0]
