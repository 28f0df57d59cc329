"""Benchmark harness of the torch port: one section per paper claim, the
counterpart of the reference's ``benchmarks/run.py`` (same ``SECTIONS``,
``ROWS``, ``emit`` and ``section,name,value,unit`` CSV), importing only
``repro_torch``, ``torch`` and ``numpy``.

    python scripts/torch_bench.py [section ...] [--device cuda|cpu]
                                  [--reduced] [--layers N]

Runs on the card unless ``--device cpu``; without a card and without
``--device cpu`` it exits non-zero.  Without ``--reduced`` every model
section runs deepseek-7b at its published widths (d_model 4096, 32 heads,
d_head 128, d_ff 11008, vocab 102400) with the depth cut to ``--layers``
(default 4), f32 weights drawn on the device from seed 0, bf16 compute, at
O2 with the kernels and ``static_jit`` on -- the main path's options; with
``--reduced`` it runs ``.reduced()``, as the reference does.  Each model
section emits its depth (``layers``) and, on the card, the launches and
refusals of each kernel it caused (``launches_<kernel>``,
``rejected_<kernel>``: the five ported kernels and the fixed-order
``batched_matmul``).

The sections keep the reference's workloads and rows.  Where the port has
no counterpart of what a row measured, the row is renamed:

  E2  ``interpreter_vs_xla_max_abs_diff`` -> ``interpreter_vs_torch_max_abs_diff``,
      ``xla_ms`` -> ``torch_ms``;
  E3  ``ir_grad_vs_jax_grad_max_abs_diff`` ->
      ``ir_grad_vs_torch_autograd_max_abs_diff``: ``torch.autograd.grad``
      of the O0 eager forward with the kernels off (a kernel launched by
      data pointer is invisible to autograd);
  E6  ``pallas_flash_vs_oracle_max_abs_diff`` ->
      ``flash_kernel_vs_oracle_max_abs_diff`` (the flash kernel against
      ``kernels/ref.py``'s oracle), plus ``flash_launches`` on the card;
  E14 the port sweeps no tiles (``backend/autotune.py``), so
      ``matmul_tile_candidates``, ``matmul_default_tile_ms``,
      ``matmul_best_tile_ms`` and ``matmul_best_over_default`` become the
      kernel against ``torch.matmul`` at ``kernels.ops.matmul_plan``'s tile
      (``matmul_tile_bm``, ``matmul_tile_bn``, ``matmul_kernel_ms``,
      ``matmul_torch_ms``, ``matmul_kernel_over_torch``), and
      ``matmul_fallback_ok`` becomes ``matmul_refused_ok`` (an odd shape
      through the emitter gives the plain result and moves the kernel's
      refusal counter, ``matmul_refused_count``); at full width the
      fused-vs-unfused rows come at deepseek-7b's prefill shape (128 rows)
      under the reference's names and at its decode shape (4 rows) as
      ``swiglu_decode_*`` and ``norm_matmul_decode_*``;
  E17 runs in process (no ``XLA_FLAGS`` child): ``EngineConfig(tp=2)``
      with both shards on the CPU, or on the one card
      (``make_mesh((2,), ("model",), devices=["cuda:0"] * 2)``), and
      ``tp2_one_card`` says so.

A parity row whose two legs attend through different forms (the dense
prefill's Attention op, which takes the flash kernel at d_head 128, against
the paged path's chunked-prefill composition: E12's continuous against
paged, E16's continuous leg and its dense leg) is taken in f32, where the
legs agree; the same comparison in the main path's 16-bit compute is
emitted beside it with a ``_bf16`` suffix and not gated.  Rows whose legs
share one form are gated in the main path's compute type, at any batch
shape or prefill chunk: E16's chunk legs on one slot against its
three-slot run, and sharing against the run alone.  Every contraction of
the paged form runs on a kernel whose sums have one order whatever the
batch (``kernels/batched_matmul.py``), so those legs give the same bits.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import torch  # noqa: E402

ROWS = []  # (section, name, value, unit) as emitted, for JSON snapshots
KERNELS = ("matmul", "norm_matmul", "swiglu", "rmsnorm", "flash_attention",
           "batched_matmul")
DEFAULT_LAYERS = 4   # full-width depth: phase 8's


class RunConfig:
    """What every section runs on (set by :func:`configure`)."""
    device = "cuda"
    reduced = False
    layers = DEFAULT_LAYERS


RUN = RunConfig()
_PARAMS = {}   # n_layers -> the full-width weights, drawn once per process


def configure(device: str = "cuda", reduced: bool = False,
              layers=None) -> RunConfig:
    """Set the device, width and depth the sections run at.  The card is
    the default; a missing card is an error, never a move to the CPU."""
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_bench: no CUDA card is attached "
                         "(torch.cuda.is_available() is false); pass "
                         "--device cpu to run on the CPU")
    RUN.device = device
    RUN.reduced = bool(reduced)
    RUN.layers = int(layers) if layers is not None else (
        0 if reduced else DEFAULT_LAYERS)
    _PARAMS.clear()
    return RUN


def on_card() -> bool:
    return RUN.device == "cuda"


def emit(section: str, name: str, value, unit: str = ""):
    if isinstance(value, float):
        value = f"{value:.6g}"
    ROWS.append({"section": section, "name": name, "value": str(value),
                 "unit": unit})
    print(f"{section},{name},{value},{unit}", flush=True)


def _sync():
    if on_card():
        torch.cuda.synchronize()


def _timeit(f, n=5, host=False):
    """Average seconds per call.  The first call warms up untimed, as the
    reference's does; on the card two do: a compiled function's first
    call runs eagerly and its second captures the CUDA graph later calls
    replay.  On the card the ``n`` timed calls lie between two CUDA
    events, recorded after a synchronize; on the CPU, or for work on the
    host (``host=True``), ``perf_counter`` times them."""
    f()
    if on_card() and not host:
        f()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        f()
    _sync()
    return (time.perf_counter() - t0) / n


# -- shared set-up ---------------------------------------------------------------
def _cfg(compute=None):
    """deepseek-7b: published widths at ``RUN.layers`` deep, or
    ``.reduced()``; ``compute`` overrides the compute type."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-7b")
    if RUN.reduced:
        cfg = cfg.reduced(**({"n_layers": RUN.layers} if RUN.layers else {}))
    else:
        cfg = dataclasses.replace(cfg, n_layers=RUN.layers)
    if compute is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute)
    return cfg


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="f32")


def _options(**kw):
    """The main path's options: O2, the kernels, ``static_jit`` (default)."""
    from repro_torch.backend import CompileOptions
    return CompileOptions(level="O2", use_pallas=True, **kw)


def _params(cfg):
    """The engines' weights: at full width drawn on the device once (f32,
    seed 0) and shared by every engine; reduced, None (each engine draws
    the builder's seeded numpy init, as the reference's engines do)."""
    if RUN.reduced:
        return None
    if cfg.n_layers not in _PARAMS:
        from repro_torch.launch.serve import full_width_builder
        from repro_torch.models.weights import init_params_on_device
        _PARAMS[cfg.n_layers] = init_params_on_device(
            full_width_builder(cfg, 64, 1), 0, RUN.device)
    return _PARAMS[cfg.n_layers]


def _engine(cfg, faults=None, options=None, **ecfg):
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    ecfg.setdefault("seed", 0)
    return ServeEngine(cfg, EngineConfig(device=RUN.device,
                                         params=_params(cfg), **ecfg),
                       options=options or _options(), faults=faults)


def free() -> None:
    """Drop every backend's compiled functions (their CUDA graphs hold
    outputs and memory pools) and release the allocator's cached blocks."""
    from repro_torch.backend import Backend
    for be in list(Backend._INSTANCES.values()):
        be.clear_cache()
    gc.collect()
    if on_card():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def counters():
    from repro_torch import kernels
    return kernels.counters()


def _kernel_rows(section: str, before) -> None:
    """On the card: each kernel's launches and refusals since ``before``
    (a :func:`counters` snapshot)."""
    if not on_card():
        return
    from repro_torch import kernels
    delta = kernels.counter_delta(before, counters())
    for k in KERNELS:
        emit(section, f"launches_{k}", delta[k]["launches"], "launches")
    for k in KERNELS:
        emit(section, f"rejected_{k}", delta[k]["rejected"], "refusals")


@contextlib.contextmanager
def _model_section(section: str, cfg):
    """A section that runs the model: its depth, then (on the card) the
    kernel launches and refusals it caused."""
    before = counters()
    yield
    _sync()
    emit(section, "layers", cfg.n_layers, "layers")
    _kernel_rows(section, before)


def _to_np(x):
    from repro_torch.devices import to_numpy
    return to_numpy(x)


def _dev(a):
    """A numpy array as a tensor on the run's device."""
    from repro_torch.devices import as_tensor, resolve_device
    return as_tensor(a, resolve_device(RUN.device))


# =============================================================================
def bench_bridges():
    from repro_torch.backend import Backend
    from repro_torch.bridges import neon, onnx_like

    net = neon.Sequential([neon.Dense(64, 256, activation="tanh", seed=1),
                           neon.Dense(256, 10, name="out", seed=2)])
    model = neon.Model(net)
    t0 = time.perf_counter()
    fn, names = neon.bridge_to_ir(model, (32, 64), loss="softmax_xent",
                                  label_shape=(32,), with_grads=True)
    emit("E1_bridges", "neon_bridge_build_ms",
         (time.perf_counter() - t0) * 1e3, "ms")
    emit("E1_bridges", "train_graph_nodes", len(fn.nodes()), "nodes")
    doc = onnx_like.export_graph(fn)
    emit("E1_bridges", "serialized_kb", len(doc) / 1024, "KiB")
    fn2 = onnx_like.import_graph(doc)
    x = np.random.default_rng(0).normal(size=(32, 64)).astype(np.float32)
    labels = np.zeros((32,), np.int32)
    args = [x, labels] + [model.param_values[n] for n in names]
    be = Backend.create("torch", device=RUN.device)
    a = be.compile(fn)(*args)
    b = be.compile(fn2)(*args)
    emit("E1_bridges", "import_export_max_abs_diff",
         float(np.abs(np.asarray(a[0]) - np.asarray(b[0])).max()), "")


def bench_backends():
    from repro_torch.backend import Backend
    from repro_torch.core import ops
    from repro_torch.core.function import Function

    x = ops.parameter((64, 512), "f32", "x")
    w = ops.parameter((512, 512), "f32", "w")
    g = ops.parameter((512,), "f32", "g")
    h = ops.rms_norm(ops.gelu(ops.matmul(x.out(), w.out())), g.out())
    fn = Function([x, w, g], [ops.softmax(h, -1)])
    rng = np.random.default_rng(0)
    args = [rng.normal(size=(64, 512)).astype(np.float32),
            rng.normal(size=(512, 512)).astype(np.float32),
            np.ones(512, np.float32)]
    it = Backend.create("interpreter").compile(fn)
    tt = Backend.create("torch", device=RUN.device).compile(fn)
    d = float(np.abs(np.asarray(it(*args)[0]) - np.asarray(tt(*args)[0])).max())
    emit("E2_backends", "interpreter_vs_torch_max_abs_diff", d, "")
    emit("E2_backends", "interpreter_ms",
         _timeit(lambda: it(*args), host=True) * 1e3, "ms")
    emit("E2_backends", "torch_ms", _timeit(lambda: tt(*args)) * 1e3, "ms")


def _autodiff_graphs():
    """The E3 MLP and its IR gradient graph (wrt w1, w2)."""
    from repro_torch.core import ops
    from repro_torch.core.autodiff import grad
    from repro_torch.core.function import Function

    x = ops.parameter((16, 128), "f32", "x")
    w1 = ops.parameter((128, 256), "f32", "w1")
    w2 = ops.parameter((256, 128), "f32", "w2")
    lb = ops.parameter((16,), "i32", "labels")
    h = ops.gelu(ops.matmul(x.out(), w1.out()))
    logits = ops.matmul(h, w2.out())
    loss = ops.reduce_mean(ops.softmax_cross_entropy(logits, lb.out()))
    fn = Function([x, w1, w2, lb], [loss])
    return fn, grad(fn, wrt=[1, 2])


def bench_autodiff():
    from repro_torch.backend import Backend, CompileOptions

    fn, gfn = _autodiff_graphs()
    emit("E3_autodiff", "fwd_nodes", len(fn.nodes()), "nodes")
    emit("E3_autodiff", "grad_nodes", len(gfn.nodes()), "nodes")
    emit("E3_autodiff", "grad_overhead_x",
         len(gfn.nodes()) / len(fn.nodes()), "x")
    rng = np.random.default_rng(1)
    args = [rng.normal(size=(16, 128)).astype(np.float32),
            rng.normal(size=(128, 256)).astype(np.float32),
            rng.normal(size=(256, 128)).astype(np.float32),
            rng.integers(0, 128, size=(16,)).astype(np.int32)]
    be = Backend.create("torch", device=RUN.device)
    outs = be.compile(gfn)(*args)
    # the forward eagerly, op by op, with plain torch ops (the kernels
    # off: a kernel launched by data pointer is invisible to autograd)
    fwd = be.compile(fn, CompileOptions(level="O0", static_jit=False,
                                        use_pallas=False)).raw
    x, w1, w2, lb = (_dev(a) for a in args)
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    tg = torch.autograd.grad(fwd(x, w1, w2, lb)[0], (w1, w2))
    d = max(float(np.abs(np.asarray(a) - _to_np(b)).max())
            for a, b in zip(outs[1:], tg))
    emit("E3_autodiff", "ir_grad_vs_torch_autograd_max_abs_diff", d, "")


def _block_graph():
    """A realistic transformer block (the memory/layout test subject)."""
    from repro_torch.core import ops
    from repro_torch.core.function import Function
    B, S, D, H, F = 4, 128, 256, 8, 512
    x = ops.parameter((B, S, D), "f32", "x")
    g1 = ops.parameter((D,), "f32", "g1")
    wq = ops.parameter((D, D), "f32", "wq")
    wk = ops.parameter((D, D), "f32", "wk")
    wv = ops.parameter((D, D), "f32", "wv")
    wo = ops.parameter((D, D), "f32", "wo")
    g2 = ops.parameter((D,), "f32", "g2")
    wi = ops.parameter((D, F), "f32", "wi")
    wo2 = ops.parameter((F, D), "f32", "wo2")
    xn = ops.rms_norm(x.out(), g1.out())

    def heads(v):
        return ops.transpose(ops.reshape(v, (B, S, H, D // H)), (0, 2, 1, 3))

    att = ops.attention(heads(ops.matmul(xn, wq.out())),
                        heads(ops.matmul(xn, wk.out())),
                        heads(ops.matmul(xn, wv.out())), causal=True)
    att = ops.reshape(ops.transpose(att, (0, 2, 1, 3)), (B, S, D))
    h = x.out() + ops.matmul(att, wo.out())
    h2 = ops.rms_norm(h, g2.out())
    out = h + ops.matmul(ops.gelu(ops.matmul(h2, wi.out())), wo2.out())
    return Function([x, g1, wq, wk, wv, wo, g2, wi, wo2], [out])


def bench_memory():
    from repro_torch.core.passes import plan_memory

    fn = _block_graph()
    plan = plan_memory(fn)
    emit("E4_memory", "naive_MB", plan.naive_bytes / 1e6, "MB")
    emit("E4_memory", "arena_MB", plan.arena_bytes / 1e6, "MB")
    emit("E4_memory", "peak_live_MB", plan.peak_live_bytes / 1e6, "MB")
    emit("E4_memory", "reuse_fraction", plan.reuse_fraction, "frac")
    emit("E4_memory", "arena_over_peak",
         plan.arena_bytes / max(plan.peak_live_bytes, 1), "x")


def bench_layout():
    from repro_torch.core import ops
    from repro_torch.core.function import Function
    from repro_torch.core.passes import LayoutAssignment

    a = ops.parameter((64, 128), "f32", "a")
    b = ops.parameter((128, 64), "f32", "b")
    t2 = ops.transpose(ops.transpose(a.out(), (1, 0)), (1, 0))
    y = ops.matmul(t2, ops.transpose(ops.transpose(b.out(), (1, 0)), (1, 0)))
    z = ops.matmul(ops.transpose(y, (1, 0)), a.out())
    fn = Function([a, b], [z])
    before = fn.op_counts().get("Transpose", 0)
    out, stats = LayoutAssignment().run(fn)
    emit("E5_layout", "transposes_before", before, "ops")
    emit("E5_layout", "transposes_after", out.op_counts().get("Transpose", 0),
         "ops")
    for k, v in stats.items():
        emit("E5_layout", k, v, "ops")


def bench_compounding():
    from repro_torch.core.cost import function_cost
    from repro_torch.core.passes import Decompose, FuseCompounds
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    fn = _block_graph()
    dec, dstats = Decompose().run(fn)
    fused, fstats = FuseCompounds().run(dec)
    emit("E6_compound", "decomposed_ops", dstats["expanded"], "ops")
    for k, v in fstats.items():
        emit("E6_compound", f"fused_{k}", v, "ops")
    emit("E6_compound", "nodes_decomposed", len(dec.nodes()), "nodes")
    emit("E6_compound", "nodes_fused", len(fused.nodes()), "nodes")
    c_x = function_cost(fused, attn_impl="chunked")
    c_f = function_cost(fused, attn_impl="flash")
    emit("E6_compound", "attn_bytes_xla_MB", c_x.bytes / 1e6, "MB")
    emit("E6_compound", "attn_bytes_flash_MB", c_f.bytes / 1e6, "MB")
    emit("E6_compound", "kernel_byte_saving_x",
         c_x.bytes / max(c_f.bytes, 1), "x")
    rng = np.random.default_rng(0)
    q = _dev(rng.normal(size=(1, 2, 256, 128)).astype(np.float32))
    k = _dev(rng.normal(size=(1, 2, 256, 128)).astype(np.float32))
    v = _dev(rng.normal(size=(1, 2, 256, 128)).astype(np.float32))
    before = counters()
    got = flash_attention(q, k, v, causal=True)
    _sync()
    launched = counters()["flash_attention"]["launches"] - \
        before["flash_attention"]["launches"]
    d = float((got - flash_attention_ref(q, k, v, causal=True)).abs().max())
    emit("E6_compound", "flash_kernel_vs_oracle_max_abs_diff", d, "")
    if on_card():
        emit("E6_compound", "flash_launches", launched, "launches")


def bench_collectives():
    from repro_torch.core import ops
    from repro_torch.core.function import Function
    from repro_torch.core.passes import CompressAllReduce

    grads = [ops.parameter((1024, 1024), "f32", f"g{i}") for i in range(8)]
    outs = [ops.all_reduce(p.out(), "data") for p in grads]
    fn = Function(grads, outs)
    comp, stats = CompressAllReduce().run(fn)

    def wire(f):
        return sum(n.inputs[0].type.nbytes for n in f.nodes()
                   if n.op == "AllReduce")

    emit("E7_collectives", "allreduce_wire_MB_f32", wire(fn) / 1e6, "MB")
    emit("E7_collectives", "allreduce_wire_MB_bf16", wire(comp) / 1e6, "MB")
    emit("E7_collectives", "compression_x", wire(fn) / wire(comp), "x")
    emit("E7_collectives", "compressed_ops", stats["compressed"], "ops")


def bench_compile_cache():
    """Cold-compile vs cached-compile latency for the serving decode step
    (the Function the engine steps token by token)."""
    from repro_torch.backend import Backend
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs

    cfg = _cfg()
    B, total = 4, 48
    with _model_section("E9_compile_cache", cfg):
        dec = build_graphs(cfg, ShapeConfig("decode", "decode", total, B), B)
        be = Backend.create("torch", fresh=True, device=RUN.device)
        opts = _options()

        t0 = time.perf_counter()
        cf = be.compile(dec.fn, opts).warmup()  # include the first call
        cold_s = time.perf_counter() - t0
        emit("E9_compile_cache", "cold_compile_ms", cold_s * 1e3, "ms")

        # a fresh serve session rebuilds the graph; structural signature hits
        dec2 = build_graphs(cfg, ShapeConfig("decode", "decode", total, B), B)
        t0 = time.perf_counter()
        cf2 = be.compile(dec2.fn, opts)
        cached_s = time.perf_counter() - t0
        assert cf2 is cf, "expected compile-cache hit"
        emit("E9_compile_cache", "cached_compile_ms", cached_s * 1e3, "ms")
        emit("E9_compile_cache", "speedup_x", cold_s / max(cached_s, 1e-9),
             "x")
        st = be.cache_stats()
        emit("E9_compile_cache", "hits", st.hits, "")
        emit("E9_compile_cache", "misses", st.misses, "")
        del cf, cf2, be


def _zero_args(fn):
    """Zero inputs of ``fn`` as tensors on the run's device (on the card a
    numpy argument would cross the bus on every call: the weights too)."""
    from repro_torch.devices import torch_dtype
    return [torch.zeros(t.shape, dtype=torch_dtype(t.dtype),
                        device=RUN.device) for t in fn.in_types]


def bench_autotune():
    """E11: autotuned knobs vs the static default on the E10 serving
    decode step, plus the persistence contract: the tuning record is
    reused sweep-free and a fresh backend over the same cache dir
    warm-starts from disk."""
    import shutil
    import tempfile

    from repro_torch.backend import Backend
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs

    cfg = _cfg()
    B, total = 4, 48
    dec = build_graphs(cfg, ShapeConfig("decode", "decode", total, B), B)
    args = _zero_args(dec.fn)
    cache_dir = tempfile.mkdtemp(prefix="repro-autotune-bench-")
    try:
        with _model_section("E11_autotune", cfg):
            opts = _options(cache_dir=cache_dir)
            be = Backend.create("torch", fresh=True, device=RUN.device)
            static = be.compile(dec.fn, opts)
            t_static = _timeit(lambda: static.raw(*args))
            emit("E11_autotune", "static_step_ms", t_static * 1e3, "ms")

            t0 = time.perf_counter()
            tuned = be.compile(dec.fn, opts.replace(autotune=True))
            emit("E11_autotune", "sweep_s", time.perf_counter() - t0, "s")
            t_tuned = _timeit(lambda: tuned.raw(*args))
            emit("E11_autotune", "tuned_step_ms", t_tuned * 1e3, "ms")
            emit("E11_autotune", "tuned_over_static_x",
                 t_static / max(t_tuned, 1e-12), "x")
            emit("E11_autotune", "winner_attn_impl",
                 tuned.options.attn_impl, "")
            emit("E11_autotune", "winner_attn_chunk",
                 tuned.options.attn_chunk, "")
            emit("E11_autotune", "winner_use_pallas",
                 int(tuned.options.use_pallas), "bool")
            emit("E11_autotune", "sweeps_first_run",
                 be.cache_stats().autotune_sweeps, "")
            del static, tuned, be

            # second consumer (fresh backend, same cache dir): the record
            # is reused -- zero sweep timings -- and the rebuilt graph's
            # compile is a *disk* hit, i.e. the pass pipeline never re-runs
            dec2 = build_graphs(cfg, ShapeConfig("decode", "decode", total, B),
                                B)
            be2 = Backend.create("torch", fresh=True, device=RUN.device)
            t0 = time.perf_counter()
            tuned2 = be2.compile(dec2.fn, opts.replace(autotune=True))
            emit("E11_autotune", "reresolve_s", time.perf_counter() - t0, "s")
            st = be2.cache_stats()
            assert st.autotune_sweeps == 0, "tuning record was not reused"
            assert st.autotune_hits == 1
            emit("E11_autotune", "sweeps_second_run", st.autotune_sweeps, "")
            emit("E11_autotune", "disk_hits_second_run", st.disk_hits, "")
            emit("E11_autotune", "pipeline_skipped_second_run",
                 int(tuned2.from_disk), "bool")
            tuned2.raw(*args)   # the re-resolved step runs
            del tuned2, be2
    finally:
        del args
        shutil.rmtree(cache_dir, ignore_errors=True)


def _kernel_shapes():
    """E14's shapes: (label infix, rows M, width D, hidden F, compute)."""
    if RUN.reduced:
        return [("", 128, 256, 512, "f32")]
    cfg = _cfg()
    return [("_decode", 4, cfg.d_model, cfg.d_ff, cfg.compute_dtype),
            ("", 128, cfg.d_model, cfg.d_ff, cfg.compute_dtype)]


def bench_kernels():
    """E14: fused compound kernels (SwiGLU / norm+matmul) vs their
    unfused decompositions, the matmul kernel against ``torch.matmul`` at
    its planned tile, and an odd shape refused through the emitter.

    Each compound graph is built in *unfused* form -- the way model
    builders emit it -- and compiled at O2 with ``autotune=True``: the
    sweep times the fused request (candidate 0) against per-compound
    fusion flips and the all-unfused baseline.  The selected config can
    never lose to the unfused baseline (both are candidates and the
    winner is the min), the ratio ``torch_bench_to_json --check``
    enforces.  At full width the shapes are deepseek-7b's decode (4 rows)
    and prefill (128 rows) in its compute type; reduced, the
    reference's."""
    import glob
    import shutil
    import tempfile

    from repro_torch.backend import Backend
    from repro_torch.core import ops
    from repro_torch.core.function import Function
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.matmul import matmul as kmatmul
    from repro_torch.kernels.ref import matmul_ref

    sec = "E14_kernels"

    def load_record(cache_dir):
        [p] = glob.glob(os.path.join(cache_dir, "autotune", "*.tune.json"))
        with open(p) as fh:
            return json.load(fh)

    def tiles(c):
        return (c["use_pallas"], c["mm_bm"], c["mm_bn"], c["mm_bk"])

    def fused_vs_unfused(name, fn):
        cache_dir = tempfile.mkdtemp(prefix=f"repro-kbench-{name}-")
        try:
            opts = _options(autotune=True, cache_dir=cache_dir)
            be = Backend.create("torch", fresh=True, device=RUN.device)
            be.compile(fn, opts)
            rec = load_record(cache_dir)
            cands = rec["candidates"]
            fused = cands[0]  # candidate 0: the request, compounds on
            unfused = next(
                c for c in cands
                if not (c["fuse_swiglu"] or c["fuse_norm_matmul"]
                        or c["fuse_rotary_qkv"]) and tiles(c) == tiles(fused))
            selected_ms = min(c["ms"] for c in cands)
            emit(sec, f"{name}_unfused_ms", unfused["ms"], "ms")
            emit(sec, f"{name}_fused_ms", fused["ms"], "ms")
            emit(sec, f"{name}_selected_ms", selected_ms, "ms")
            emit(sec, f"{name}_selected_over_unfused",
                 selected_ms / unfused["ms"], "x")
            del be
        finally:
            shutil.rmtree(cache_dir, ignore_errors=True)

    before = counters()
    for infix, M, D, F, dt in _kernel_shapes():
        # unfused swiglu MLP block, the shape components.apply_mlp emits
        x = ops.parameter((M, D), dt, "x")
        wg = ops.parameter((D, F), dt, "wg")
        wu = ops.parameter((D, F), dt, "wu")
        wd = ops.parameter((F, D), dt, "wd")
        g = ops.silu(ops.matmul(x.out(), wg.out()))
        u = ops.matmul(x.out(), wu.out())
        fused_vs_unfused(f"swiglu{infix}", Function(
            [x, wg, wu, wd], [ops.matmul(ops.multiply(g, u), wd.out())]))

        # unfused rmsnorm feeding a matmul (pre-attention / unembed shape)
        x2 = ops.parameter((M, D), dt, "x2")
        gn = ops.parameter((D,), dt, "gn")
        w2 = ops.parameter((D, D), dt, "w2")
        fused_vs_unfused(f"norm_matmul{infix}", Function(
            [x2, gn, w2],
            [ops.matmul(ops.rms_norm(x2.out(), gn.out()), w2.out())]))

    # the matmul kernel at its planned tile against torch.matmul, then a
    # sweep-free re-resolution of the matmul graph from its record
    _, M, D, _, dt = _kernel_shapes()[-1]
    if RUN.reduced:
        M = D = 256
    a = ops.parameter((M, D), dt, "a")
    b = ops.parameter((D, D), dt, "b")
    mm = Function([a, b], [ops.matmul(a.out(), b.out())])
    from repro_torch.devices import torch_dtype
    tdt = torch_dtype(dt)
    gen = torch.Generator(device=RUN.device)
    gen.manual_seed(0)
    at = torch.randn((M, D), generator=gen, device=RUN.device).to(tdt)
    bt = torch.randn((D, D), generator=gen, device=RUN.device).to(tdt)
    plan = kops.matmul_plan(M, D, D, tdt)
    emit(sec, "matmul_tile_route", plan.route, "")
    emit(sec, "matmul_tile_bm", plan.bm, "rows")
    emit(sec, "matmul_tile_bn", plan.bn, "cols")
    k_ms = _timeit(lambda: kmatmul(at, bt)) * 1e3
    t_ms = _timeit(lambda: torch.matmul(at, bt)) * 1e3
    emit(sec, "matmul_kernel_ms", k_ms, "ms")
    emit(sec, "matmul_torch_ms", t_ms, "ms")
    emit(sec, "matmul_kernel_over_torch", k_ms / max(t_ms, 1e-12), "x")
    cache_dir = tempfile.mkdtemp(prefix="repro-kbench-matmul-")
    try:
        opts = _options(autotune=True, cache_dir=cache_dir)
        Backend.create("torch", fresh=True, device=RUN.device).compile(mm, opts)
        be2 = Backend.create("torch", fresh=True, device=RUN.device)
        be2.compile(mm, opts)
        st = be2.cache_stats()
        assert st.autotune_sweeps == 0, "tuning record was not reused"
        emit(sec, "matmul_reresolve_sweep_free",
             int(st.autotune_sweeps == 0 and st.autotune_hits == 1), "bool")
        del be2
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    _sync()
    _kernel_rows(sec, before)

    # an odd shape (N = 33 is no whole number of 16-byte vectors) through
    # the emitter: the matmul kernel's predicate refuses it, counted, and
    # the fixed-order batched kernel (the plain product on the CPU)
    # answers -- never a hidden fallback
    rng = np.random.default_rng(7)
    am = rng.normal(size=(7, 100)).astype(np.float32)
    bm = rng.normal(size=(100, 33)).astype(np.float32)
    pa = ops.parameter((7, 100), "f32", "a")
    pb = ops.parameter((100, 33), "f32", "b")
    odd = Function([pa, pb], [ops.matmul(pa.out(), pb.out())])
    before = counters()
    got = Backend.create("torch", device=RUN.device).compile(
        odd, _options())(am, bm)[0]
    after = counters()
    refused = after["matmul"]["rejected"] - before["matmul"]["rejected"]
    launched = after["matmul"]["launches"] - before["matmul"]["launches"]
    want = matmul_ref(torch.from_numpy(am), torch.from_numpy(bm)).numpy()
    ok = bool(np.allclose(got, want, atol=1e-4)) and launched == 0 and (
        refused >= 1 or not on_card())
    emit(sec, "matmul_refused_ok", int(ok), "bool")
    emit(sec, "matmul_refused_count", refused, "refusals")


def bench_serving():
    """E10: the serving hot loop -- lockstep host-round-trip baseline vs
    donated device-resident decode vs continuous batching (ServeEngine).

    ``*_decode_tok_s`` is the steady-state hot loop; ``*_tok_s`` is end
    to end including prefill.

    Latency semantics: lockstep/continuous p50/p95 are real per-dispatch
    step durations; donated fuses the whole generation into one dispatch,
    so its p50/p95 is the time-to-token of that chunk.  Each mode warms
    twice: on the card a compiled function's first call runs eagerly and
    its second captures, and donated makes one call a generation."""
    cfg = _cfg()
    SLOTS, P, G = 4, 16, 48
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(P,)) for _ in range(SLOTS)]

    def run_mode(mode, n_req=SLOTS, warm=False):
        eng = _engine(cfg, mode=mode, slots=SLOTS, max_len=P + G)
        for i in range(n_req):
            eng.submit(prompts[i % SLOTS], G)
        rep = eng.run()
        if warm:
            return rep
        emit("E10_serving", f"{mode}_tok_s", rep.tok_s, "tok/s")
        emit("E10_serving", f"{mode}_decode_tok_s", rep.decode_tok_s, "tok/s")
        emit("E10_serving", f"{mode}_p50_ms", rep.p50_ms, "ms")
        emit("E10_serving", f"{mode}_p95_ms", rep.p95_ms, "ms")
        emit("E10_serving", f"{mode}_ttft_p50_ms", rep.ttft_p50_ms, "ms")
        emit("E10_serving", f"{mode}_ttft_p95_ms", rep.ttft_p95_ms, "ms")
        return rep

    with _model_section("E10_serving", cfg):
        reps = {}
        for mode in ("lockstep", "donated", "continuous"):
            for _ in range(2):   # first calls, then captures
                run_mode(mode, warm=True)
            reps[mode] = run_mode(mode)
        base = reps["lockstep"].results
        agree = all(np.array_equal(base[r], reps["donated"].results[r])
                    for r in base)
        emit("E10_serving", "donated_matches_lockstep", int(agree), "bool")
        # continuous-batching isolation: each request's output must match
        # a run where it is alone in the engine (slot sharing leaks nothing)
        alone_ok = True
        for i in range(SLOTS):
            eng = _engine(cfg, mode="continuous", slots=SLOTS, max_len=P + G)
            rid = eng.submit(prompts[i], G)
            alone_ok &= np.array_equal(eng.run().results[rid],
                                       reps["continuous"].results[i])
        emit("E10_serving", "continuous_matches_alone", int(alone_ok), "bool")
        emit("E10_serving", "donated_speedup_x",
             reps["donated"].decode_tok_s
             / max(reps["lockstep"].decode_tok_s, 1e-9), "x")
        emit("E10_serving", "continuous_speedup_x",
             reps["continuous"].decode_tok_s
             / max(reps["lockstep"].decode_tok_s, 1e-9), "x")
        # continuous batching under oversubscription: 8 requests on 4 slots
        rep8 = run_mode("continuous", n_req=8, warm=True)
        emit("E10_serving", "continuous_8on4_tok_s", rep8.tok_s, "tok/s")
        emit("E10_serving", "continuous_8on4_decode_tok_s",
             rep8.decode_tok_s, "tok/s")
        emit("E10_serving", "continuous_8on4_late_admissions",
             rep8.late_admissions, "reqs")
        p = rep8.pool
        emit("E10_serving", "kv_pool_bytes_per_slot", p.bytes_per_slot, "B")
        emit("E10_serving", "kv_pool_allocs", p.allocs, "")
        emit("E10_serving", "kv_pool_peak_active", p.peak_active, "slots")


def _f32_parity(cfg) -> bool:
    """Whether a parity row across attention forms or batch shapes is
    taken in f32 (the main path computes in 16 bits)."""
    return cfg.compute_dtype != "f32"


def bench_paged():
    """E12: the paged KV pool vs the fixed-row continuous pool.

    A mixed-length workload (short and long requests interleaved) is
    where fixed rows waste the most: every slot reserves ``max_len`` KV
    rows regardless of the request occupying it, while the paged pool
    allocates pages lazily as positions cross page boundaries.  The
    headline rows are ``kv_bytes_per_active_token`` for both modes --
    paged must be *strictly* lower -- plus decode tok/s and greedy token
    parity.  Continuous mode prefills through the dense prefill's
    Attention op and paged mode through the chunked-prefill composition,
    two forms, so the gated parity row is taken in f32."""
    cfg = _cfg()
    SLOTS, MAX_LEN, PS, K = 4, 64, 8, 4
    rng = np.random.default_rng(0)
    # mixed lengths: 4..16-token prompts, 6..40-token generations
    workload = [(rng.integers(0, cfg.vocab, size=(p,)).astype(np.int32), g)
                for p, g in [(4, 6), (16, 40), (6, 10), (12, 32),
                             (4, 8), (8, 24)]]

    def run_mode(mode, warm=False, model=cfg, **kw):
        eng = _engine(model, mode=mode, slots=SLOTS, max_len=MAX_LEN, **kw)
        rids = [eng.submit(p, g) for p, g in workload]
        rep = eng.run()
        if not warm:
            emit("E12_paged", f"{mode}_tok_s", rep.tok_s, "tok/s")
            emit("E12_paged", f"{mode}_decode_tok_s", rep.decode_tok_s,
                 "tok/s")
            emit("E12_paged", f"{mode}_kv_bytes_per_active_token",
                 rep.kv_bytes_per_active_token, "B/tok")
            emit("E12_paged", f"{mode}_ttft_p95_ms", rep.ttft_p95_ms, "ms")
        return rids, rep, eng

    def agree(a, b):
        (crids, crep, _), (prids, prep, _) = a, b
        return all(np.array_equal(crep.results[c], prep.results[p])
                   for c, p in zip(crids, prids))

    paged_kw = dict(page_size=PS, chunk_steps=K)
    with _model_section("E12_paged", cfg):
        run_mode("continuous", warm=True)
        cont = run_mode("continuous")
        run_mode("paged", warm=True, **paged_kw)
        paged = run_mode("paged", **paged_kw)
        same = agree(cont, paged)
        if _f32_parity(cfg):
            emit("E12_paged", "paged_matches_continuous_bf16", int(same),
                 "bool")
            same = agree(run_mode("continuous", warm=True, model=_f32(cfg)),
                         run_mode("paged", warm=True, model=_f32(cfg),
                                  **paged_kw))
        emit("E12_paged", "paged_matches_continuous", int(same), "bool")
        assert same, "paged greedy output diverged from continuous"
        crep, (_, prep, eng) = cont[1], paged
        ratio = prep.kv_bytes_per_active_token / crep.kv_bytes_per_active_token
        emit("E12_paged", "paged_kv_bytes_ratio", ratio, "x")
        assert ratio < 1.0, (
            f"paged pool must reserve strictly fewer KV bytes per active "
            f"token than fixed rows on a mixed-length workload (got "
            f"{ratio:.3f}x)")
        p = prep.pool
        emit("E12_paged", "page_size", p.page_size, "tokens")
        emit("E12_paged", "chunk_steps", K, "steps")
        emit("E12_paged", "peak_pages_in_use", p.peak_pages_in_use, "pages")
        emit("E12_paged", "fragmentation", p.fragmentation, "frac")
        emit("E12_paged", "page_allocs", p.page_allocs, "")
        emit("E12_paged", "page_frees", p.page_frees, "")
        assert p.pages_in_use == 0 and p.page_allocs == p.page_frees, \
            "page leak: pool did not drain"


def bench_server():
    """E13: the HTTP front door under over-subscription.

    Three times more concurrent streaming clients than the engine has
    slots, all firing at once against a paged-mode server -- TTFT p50/p95
    as each client saw it, inter-token spacing, sustained tok/s from the
    server's rolling window -- plus the two invariants: every greedy
    stream token-identical to driving the ServeEngine directly, and a
    graceful drain that returns every KV page."""
    from repro_torch.launch import loadgen
    from repro_torch.launch.server import running_server

    cfg = _cfg()
    SLOTS, P, G, CLIENTS = 2, 8, 24, 6

    def make_engine():
        return _engine(cfg, mode="paged", slots=SLOTS, max_len=P + G,
                       page_size=8, chunk_steps=4)

    with _model_section("E13_server", cfg):
        prompts = loadgen.make_prompts(CLIENTS, P, cfg.vocab, seed=0)
        # the direct-engine reference: parity baseline + first calls
        # (Backend.create memoizes, so the served engine reuses the cache)
        ref = make_engine()
        rrids = [ref.submit(p, G) for p in prompts]
        rrep = ref.run()

        eng = make_engine()
        with running_server(eng, max_wait_queue=CLIENTS) as srv:
            res = loadgen.run_load(srv.base_url, prompts, G)
        assert not res.errors, f"load run failed: {res.errors}"
        assert res.statuses == {200: CLIENTS}, res.statuses

        emit("E13_server", "server_clients", CLIENTS, "clients")
        emit("E13_server", "server_slots", SLOTS, "slots")
        emit("E13_server", "server_tok_s", res.tok_s, "tok/s")
        emit("E13_server", "server_sustained_tok_s",
             srv.stats.snapshot()["sustained_tok_s"], "tok/s")
        emit("E13_server", "server_ttft_p50_ms", res.ttft_p50_ms, "ms")
        emit("E13_server", "server_ttft_p95_ms", res.ttft_p95_ms, "ms")
        emit("E13_server", "server_tok_p50_ms", res.gap_p50_ms, "ms")
        emit("E13_server", "server_tok_p95_ms", res.gap_p95_ms, "ms")
        match = all(res.results[str(i)] == rrep.results[r].tolist()
                    for i, r in enumerate(rrids))
        emit("E13_server", "server_matches_engine", int(match), "bool")
        assert match, "served greedy streams diverged from the direct engine"
        emit("E13_server", "server_drain_clean", int(bool(srv.drain_ok)),
             "bool")
        assert srv.drain_ok, "drain left pages/slots in use"
        emit("E13_server", "server_late_admissions",
             srv.engine_report.late_admissions, "reqs")


def bench_faults():
    """E15: the request-lifecycle fault-tolerance contract under load.

    Three injected scenarios against the paged engine, each gated on the
    invariant the chaos leg enforces: the pool drains to exactly zero
    pages and the request that was *not* injected decodes token for token
    what a clean solo run produces (cancel and its reclaim latency at the
    chunk boundary; a deadline expiring mid-decode; an injected dispatch
    failure, contained, the engine degraded and still serving)."""
    from repro_torch.launch.faults import FaultInjector

    cfg = _cfg()
    P, G = 4, 8
    rng = np.random.default_rng(0)
    pa = rng.integers(0, cfg.vocab, size=(P,)).astype(np.int32)
    pb = rng.integers(0, cfg.vocab, size=(P,)).astype(np.int32)

    def make_engine(faults=None):
        return _engine(cfg, faults=faults, mode="paged", slots=2, max_len=40,
                       page_size=4, chunk_steps=1)

    with _model_section("E15_faults", cfg):
        solo = make_engine()
        rs = solo.submit(pb, G)
        ref = list(solo.run().results[rs])

        # -- cancel: reclaim latency at the chunk boundary --------------------
        eng = make_engine()
        ra = eng.submit(pa, 32)
        rb = eng.submit(pb, G)
        eng.step()
        assert eng.cancel(ra, "bench cancel") is True
        t0 = time.perf_counter()
        eng.step()  # the boundary where the cancel lands
        reclaim_ms = (time.perf_counter() - t0) * 1e3
        assert eng._requests[ra].slot is None, "cancel did not free the slot"
        rep = eng.run()
        parity = list(rep.results[rb]) == ref
        cancelled = rep.counters["cancelled"]
        pages_ok = eng.pool.pages_in_use == 0 and eng.pool.verify() == []
        emit("E15_faults", "faults_cancel_reclaim_ms", reclaim_ms, "ms")

        # -- deadline: expiry mid-decode is its own terminal status -----------
        eng = make_engine()
        rd = eng.submit(pa, 32, deadline_s=60.0)
        eng.step()
        eng._requests[rd].deadline = 0.0  # expire deterministically
        eng.step()
        rep = eng.run()
        deadline_total = rep.counters["deadline_exceeded"]
        pages_ok &= eng.pool.pages_in_use == 0 and eng.pool.verify() == []

        # -- dispatch failure: contained, degraded, still serving -------------
        eng = make_engine(faults=FaultInjector("dispatch.raise=after:2"))
        ri = eng.submit(pa, G)
        eng.step()
        eng.step()  # injected FaultError: contained, request failed
        contained = (eng._requests[ri].status == "failed"
                     and eng.health == "degraded")
        rb2 = eng.submit(pb, G)
        rep = eng.run()
        parity &= list(rep.results[rb2]) == ref
        engine_errors = rep.counters["engine_errors"]
        pages_ok &= eng.pool.pages_in_use == 0 and eng.pool.verify() == []

        emit("E15_faults", "faults_cancelled_total", cancelled, "reqs")
        emit("E15_faults", "faults_deadline_total", deadline_total, "reqs")
        emit("E15_faults", "faults_engine_errors_total", engine_errors,
             "errors")
        emit("E15_faults", "faults_dispatch_contained", int(contained), "bool")
        emit("E15_faults", "faults_pages_reclaimed", int(pages_ok), "bool")
        emit("E15_faults", "faults_uninjected_parity", int(parity), "bool")
        assert contained, "dispatch failure was not contained"
        assert pages_ok, "a fault scenario leaked pages"
        assert parity, "an uninjected request lost token parity"


def bench_prefix():
    """E16: copy-on-write prefix page sharing + in-graph chunked prefill.

    Headline: on a shared-system-prompt workload (three requests with an
    identical 32-token prompt) the sharing pool reserves <= 0.6x the KV
    bytes per active token of the unshared paged pool, while greedy
    outputs stay token-identical to continuous mode and to each request
    run alone.  Continuous mode and the dense prefill (``prefill_chunk=0``)
    attend through the dense prefill's Attention op and the paged legs
    through the chunked-prefill composition: the continuous and dense
    comparisons are taken in f32 (``prefix_dense_prefill_parity`` is the
    dense leg's own row).  Sharing against the run alone, and the chunk
    legs (5 and 16 on one slot) against the three-slot run alone, share
    the paged form and are gated in the main path's compute type.  The
    stall rows
    show why prefill moved in-graph and chunked: a long prompt admitted
    mid-decode stalls a short victim's inter-token p95 for one whole
    dense prefill, vs one bounded chunk at a time."""
    cfg = _cfg()
    cfg32 = _f32(cfg) if _f32_parity(cfg) else cfg
    SLOTS, P, G, PS, MAX_LEN = 3, 32, 8, 4, 40
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(P,)).astype(np.int32)

    def run_paged(sharing, model=cfg, **kw):
        eng = _engine(model, mode="paged", slots=SLOTS, max_len=MAX_LEN,
                      page_size=PS, chunk_steps=2, prefix_sharing=sharing,
                      **kw)
        rids = [eng.submit(prompt, G) for _ in range(SLOTS)]
        rep = eng.run()
        assert eng.pool.verify() == [] and rep.pool.pages_in_use == 0, \
            "shared-prefix run must drain every refcounted page"
        return rids, rep

    def continuous(model):
        cont = _engine(model, mode="continuous", slots=SLOTS, max_len=MAX_LEN)
        crids = [cont.submit(prompt, G) for _ in range(SLOTS)]
        return crids, cont.run()

    def alone(model, slots=SLOTS, **kw):
        eng = _engine(model, mode="paged", slots=slots, max_len=MAX_LEN,
                      page_size=PS, chunk_steps=2, **kw)
        rid = eng.submit(prompt, G)
        return eng.run().results[rid]

    def parity_of(srids, srep, crids, crep, aref):
        same_alone = all(np.array_equal(srep.results[s], aref)
                         for s in srids)
        same_cont = all(np.array_equal(srep.results[s], crep.results[c])
                        for s, c in zip(srids, crids))
        return same_alone, same_cont

    with _model_section("E16_prefix", cfg):
        run_paged(True)  # first calls + captures
        srids, srep = run_paged(True)
        urids, urep = run_paged(False)
        crids, crep = continuous(cfg)
        aref = alone(cfg)
        same_alone, same_cont = parity_of(srids, srep, crids, crep, aref)
        if cfg32 is not cfg:
            # sharing against alone stays in the compute type; against
            # continuous (another form) in f32
            emit("E16_prefix", "prefix_parity_bf16",
                 int(same_alone and same_cont), "bool")
            s32, c32 = run_paged(True, model=cfg32), continuous(cfg32)
            _, same_cont = parity_of(*s32, *c32, None)
        parity = same_alone and same_cont
        emit("E16_prefix", "prefix_parity", int(parity), "bool")
        assert parity, "prefix sharing changed greedy outputs"

        skv = srep.kv_bytes_per_active_token
        ukv = urep.kv_bytes_per_active_token
        ratio = skv / ukv
        emit("E16_prefix", "prefix_shared_kv_bytes_per_token", skv, "B/tok")
        emit("E16_prefix", "prefix_unshared_kv_bytes_per_token", ukv,
             "B/tok")
        emit("E16_prefix", "prefix_kv_bytes_ratio", ratio, "x")
        assert ratio <= 0.6, (
            f"shared-prefix pool must collapse KV bytes per active token to "
            f"<= 0.6x the unshared paged pool, got {ratio:.3f}x")
        p = srep.pool
        emit("E16_prefix", "prefix_cow_copies", p.cow_copies, "")
        emit("E16_prefix", "prefix_shared_attaches", p.shared_attaches, "")
        emit("E16_prefix", "prefix_peak_pages_shared", p.peak_pages_in_use,
             "pages")
        emit("E16_prefix", "prefix_peak_pages_unshared",
             urep.pool.peak_pages_in_use, "pages")
        assert p.cow_copies >= 1 and p.shared_attaches >= 1

        # chunked prefill exactness: every chunk size (ragged tails
        # included) decodes the same tokens on one slot as the three-slot
        # run alone, in the compute type; the dense path (another form)
        # in f32
        chunk_ok = all(np.array_equal(alone(cfg, 1, prefill_chunk=c), aref)
                       for c in (5, 16))
        emit("E16_prefix", "prefix_chunked_prefill_parity", int(chunk_ok),
             "bool")
        assert chunk_ok, "chunked prefill diverged between chunk sizes"
        dense_ok = np.array_equal(alone(cfg, 1, prefill_chunk=0), aref)
        if cfg32 is not cfg:
            emit("E16_prefix", "prefix_dense_prefill_parity_bf16",
                 int(dense_ok), "bool")
            dense_ok = np.array_equal(alone(cfg32, 1, prefill_chunk=0),
                                      alone(cfg32))
        emit("E16_prefix", "prefix_dense_prefill_parity", int(dense_ok),
             "bool")
        assert dense_ok, "chunked prefill diverged from dense prefill"

        # prefill stall: a short victim decodes while a 32-token prompt is
        # admitted mid-stream; the victim's p95 inter-token gap under
        # chunked prefill (one bounded chunk per step) vs dense prefill
        # (the whole prompt in one dispatch stalls the step loop)
        victim = rng.integers(0, cfg.vocab, size=(4,)).astype(np.int32)

        def stall_p95(prefill_chunk):
            def once():
                eng = _engine(cfg, mode="paged", slots=2, max_len=MAX_LEN,
                              page_size=PS, chunk_steps=1,
                              prefix_sharing=False,
                              prefill_chunk=prefill_chunk)
                rv = eng.submit(victim, 24)
                arrivals = []
                intruded = False
                while not eng._requests[rv].done:
                    if not intruded and len(eng._requests[rv].tokens) >= 2:
                        eng.submit(prompt, 2)  # long prompt lands mid-decode
                        intruded = True
                    for rid, _ in eng.step():
                        if rid == rv:
                            arrivals.append(time.perf_counter())
                eng.run()
                return arrivals
            once()  # warm every graph this schedule compiles
            arrivals = once()
            gaps = np.diff(arrivals) * 1e3
            return float(np.percentile(gaps, 95))

        emit("E16_prefix", "prefix_stall_p95_ms_chunked", stall_p95(PS), "ms")
        emit("E16_prefix", "prefix_stall_p95_ms_dense", stall_p95(0), "ms")


def bench_partition():
    """E17: tensor-parallel paged serving over the partition pass.

    The same greedy workload at tp=1 and tp=2: decode tok/s, per-device
    KV bytes (each shard holds n_kv_heads/tp heads of every page, so
    bytes per device must be exactly half), token parity, and the
    collective counts the PartitionGraph pass recorded.  Both shards run
    on one device -- the CPU, or the one card through an explicit mesh --
    so the tok/s pair is a parity and memory claim, never a two-card
    speed-up (``tp2_one_card``)."""
    from repro_torch.backend.sharding import make_mesh

    cfg = _cfg()
    SLOTS, P, G, MAX_LEN = 4, 16, 24, 48
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(P,)).astype(np.int32)
               for _ in range(SLOTS)]
    shards = [RUN.device + (":0" if on_card() else "")] * 2

    def run(tp):
        opts = _options(mesh=make_mesh((tp,), ("model",),
                                       devices=shards[:tp])) \
            if tp > 1 and on_card() else _options()
        eng = _engine(cfg, options=opts, mode="paged", slots=SLOTS,
                      max_len=MAX_LEN, page_size=8, chunk_steps=4, tp=tp)
        for p in prompts:
            eng.submit(p, G)
        return eng.run(), eng

    with _model_section("E17_partition", cfg):
        for tp in (1, 2):          # first calls + captures
            run(tp)
        r1, e1 = run(1)
        r2, e2 = run(2)
        parity = all(np.array_equal(r1.results[k], r2.results[k])
                     for k in r1.results)
        assert r2.pool.pages_in_use == 0 and e2.pool.verify() == []
        st = e2.cf.report.stats.get("partition") or {}
        emit("E17_partition", "tp1_decode_tok_s", r1.decode_tok_s, "tok/s")
        emit("E17_partition", "tp2_decode_tok_s", r2.decode_tok_s, "tok/s")
        emit("E17_partition", "tp2_over_tp1_decode",
             r2.decode_tok_s / max(r1.decode_tok_s, 1e-9), "x")
        emit("E17_partition", "tp2_one_card", int(len(set(shards)) == 1),
             "bool")
        emit("E17_partition", "tp2_matches_tp1", int(parity), "bool")
        assert parity, "tp=2 greedy output diverged from tp=1"
        emit("E17_partition", "kv_bytes_per_device_tp1",
             r1.kv_bytes_per_device, "B")
        emit("E17_partition", "kv_bytes_per_device_tp2",
             r2.kv_bytes_per_device, "B")
        ratio = r2.kv_bytes_per_device / r1.kv_bytes_per_device
        emit("E17_partition", "kv_bytes_per_device_ratio", ratio, "x")
        assert ratio <= 0.5, \
            f"tp=2 must halve per-device KV bytes, got {ratio:.3f}x"
        emit("E17_partition", "partition_all_gather",
             st.get("all_gather", 0), "nodes")
        emit("E17_partition", "partition_all_reduce",
             st.get("all_reduce", 0), "nodes")
        emit("E17_partition", "partition_params_sharded",
             st.get("params_sharded", 0), "params")
        emit("E17_partition", "partition_scan_bodies",
             st.get("scan_bodies", 0), "bodies")
        assert st.get("all_gather", 0) >= 1 \
            and st.get("params_sharded", 0) >= 1, \
            "partition pass reported no sharding work"


def bench_scaling():
    """The dry-run roofline table (claim E8): the records
    ``python -m repro_torch.launch.dryrun`` writes."""
    base = os.path.join(REPO, "results", "dryrun_torch")
    if not os.path.isdir(base):
        emit("E8_scaling", "dryrun_results",
             "missing:run repro_torch.launch.dryrun", "")
        return
    for mesh_name in sorted(os.listdir(base)):
        mdir = os.path.join(base, mesh_name)
        for f in sorted(os.listdir(mdir)):
            with open(os.path.join(mdir, f)) as fh:
                r = json.load(fh)
            cell = f.replace(".json", "")
            emit("E8_scaling", f"{mesh_name}/{cell}",
                 f"{r['bottleneck']}:{r['roofline_fraction']:.3f}",
                 "bottleneck:roofline")


def bench_train_loop():
    """End-to-end sanity: the model trains (loss falls) -- 40 steps of the
    IR train step (autodiff + AdamW), p, m and v donated and kept on the
    device."""
    from repro_torch.backend import Backend
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.devices import as_tensor, resolve_device, torch_dtype
    from repro_torch.models.lm import build_graphs
    from repro_torch.models.train_graph import make_train_step
    from repro_torch.models.weights import init_params_on_device
    from repro_torch.runtime.data import DataConfig, SyntheticLM

    cfg = _cfg()
    with _model_section("E2_backends", cfg):
        g = build_graphs(cfg, ShapeConfig("train", "train", 32, 8), 8)
        ts = make_train_step(g, cfg)
        n_data, n_p = len(g.builder.inputs), ts.n_params
        donate = tuple(range(n_data + 1, n_data + 1 + 3 * n_p))
        dev = resolve_device(RUN.device)
        if RUN.reduced:
            init = g.builder.init_params(0)
            params = {n: as_tensor(init[n], dev) for n in ts.param_names}
        else:
            params = init_params_on_device(g.builder, 0, dev)
        opt = torch_dtype(cfg.opt_dtype)
        ps = [params[n] for n in ts.param_names]
        del params
        flat = ps + [torch.zeros_like(t, dtype=opt) for t in ps] + \
            [torch.zeros_like(t, dtype=opt) for t in ps]
        del ps
        ex = Backend.create("torch", device=RUN.device).compile(
            ts.fn, _options(donate_argnums=donate))
        data = SyntheticLM(DataConfig(cfg.vocab, 32, 8))
        losses = []
        t0 = time.perf_counter()
        for step in range(40):
            batch = data.batch(step)
            outs = ex.raw(batch["tokens"], batch["labels"], np.int32(step),
                          *flat)
            losses.append(float(outs[0]))
            flat = list(outs[1:])
            del outs
        emit("E2_backends", "train40_s", time.perf_counter() - t0, "s")
        emit("E2_backends", "loss_first5", float(np.mean(losses[:5])), "nats")
        emit("E2_backends", "loss_last5", float(np.mean(losses[-5:])), "nats")
        del flat, ex
        assert np.mean(losses[-5:]) < np.mean(losses[:5])


SECTIONS = {
    "bridges": bench_bridges,
    "backends": bench_backends,
    "autodiff": bench_autodiff,
    "memory": bench_memory,
    "layout": bench_layout,
    "compounding": bench_compounding,
    "collectives": bench_collectives,
    "compile_cache": bench_compile_cache,
    "serving": bench_serving,
    "paged": bench_paged,
    "server": bench_server,
    "prefix": bench_prefix,
    "partition": bench_partition,
    "autotune": bench_autotune,
    "kernels": bench_kernels,
    "faults": bench_faults,
    "scaling": bench_scaling,
    "train_loop": bench_train_loop,
}


def run_sections(names, stats=None) -> None:
    """Run ``names`` in order, freeing the card between sections; with
    ``stats`` (a dict), record each section's seconds and kernel launches
    in it."""
    unknown = [s for s in names if s not in SECTIONS]
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; "
                         f"available: {sorted(SECTIONS)}")
    from repro_torch import kernels
    for name in names:
        before = counters()
        t0 = time.perf_counter()
        SECTIONS[name]()
        _sync()
        if stats is not None:
            delta = kernels.counter_delta(before, counters())
            stats[name] = {"seconds": time.perf_counter() - t0,
                           "launches": {k: delta[k]["launches"]
                                        for k in KERNELS},
                           "rejected": {k: delta[k]["rejected"]
                                        for k in KERNELS}}
        free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*", help="default: all")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the sections run (default: the card)")
    ap.add_argument("--reduced", action="store_true",
                    help="deepseek-7b .reduced(), as the reference runs")
    ap.add_argument("--layers", type=int, default=None,
                    help=f"depth of the model sections (default "
                         f"{DEFAULT_LAYERS} at full width, the reduced "
                         f"config's own with --reduced)")
    args = ap.parse_args(argv)
    configure(args.device, args.reduced, args.layers)
    print("section,name,value,unit")
    run_sections(args.sections or list(SECTIONS))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
