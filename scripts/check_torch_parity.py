"""Parity gate of the torch port against the JAX package on the serving
graphs (the port's counterpart of ``scripts/check_kernel_parity.py``).

This is the one file outside the tests that imports both packages: it
holds ``repro_torch`` to ``repro``, as the reference's parity scripts
hold one lowering to another.  The port itself imports neither ``jax``
nor ``repro``.

For each graph kind of the dense family (deepseek-7b) -- the ``train``
loss graph and the whole train step (``train_step``: IR autodiff +
AdamW, ``models.train_graph.make_train_step``), ``prefill``, ``decode``,
``serve``, the paged decode chunk and the paged prefill chunk -- and of
the moe family (mixtral-8x22b: ``train``, ``prefill``, ``decode`` and
the sliding window's ring ``long_decode``), the mla_moe family
(deepseek-v3-671b: ``train`` with its MTP head, ``prefill``, ``decode``
over the latent caches), and the recurrent families (recurrentgemma-9b,
``rg_hybrid``, and xlstm-350m: ``train``, ``prefill``, ``decode`` over
the recurrent states and ``long_decode``), and the multimodal families
(whisper-medium, ``encdec``, and llama-3.2-vision-11b, ``vlm``:
``train``, ``prefill`` with the stubbed frames or images, ``decode``
over the self and cross caches), the same graph is built by both
packages (their structural signatures must agree) and run on the same
numpy inputs (the recipe of ``check_kernel_parity.make_args``: the builder's seeded weights, integer
inputs drawn below ``min(vocab, 100)``, float inputs zero) three ways:
JAX at O1, torch at O1, and torch at O2 with ``use_pallas=True`` (the
fused compounds through the Hopper kernels on the card, their plain
versions on the CPU).  The gate fails unless

  * the O2 pipeline formed at least the compounds of ``EXPECTED``;
  * each torch output agrees with JAX's: integer outputs exactly, float
    outputs within 1e-4 of scale in f32 and 3e-2 in bf16, and logits
    (last dim the vocabulary) with the same argmax (``compare``, as in
    ``check_kernel_parity``).  The train kinds' f32 outputs (the loss,
    and the step's new parameters and moments) are computed in the
    config's compute dtype, so they are held to that dtype's tolerance,
    and the step has no logits among its outputs (its moments of the
    unembedding end in the vocabulary too).  The step's moments are
    gradient-sized, far below that scale's floor of 1, and its update is
    smaller still, so each new moment is also held within the tolerance
    of its own norm (L2), and each parameter's update (new minus given)
    against JAX's in norm ratio and, within ``UPDATE_L2``, in direction
    (``compare_train_state``);
  * on a CUDA device, every kernel on a graph's path launched at least
    once in its O2 run (the launch counters; the reduced vocabulary's
    unembed is refused by the kernels' shape rule and runs plain;
    mixtral's experts are batched einsums and xlstm's FFN is GeLU-gated,
    so neither runs SwiGLU; no xlstm graph holds an Attention op;
    whisper's norms are LayerNorms and its MLP GeLU, so it runs matmul
    and, at d_head 128, flash only: ``serve.smoke_kernels``).

The ``tp`` kind (``--kind tp``, and part of ``--kind all``, the
default) holds the port's partition pass to the reference's: the paged
decode chunk and the paged prefill chunk of deepseek-7b, optimized at O1
and at O2 (the fusion gates on) with the ``tp`` profile's
PartitionGraph last, must give the same structural signature and the
same pass stats (params sharded, AllGathers, AllReduces, Scan bodies)
in both packages.  It runs the reference's pass directly, from the
port's ``partition_profile("tp")`` (the tests hold the two profiles
equal), so it imports no jax and needs no devices.  ``--tp-width full``
builds the graphs at deepseek-7b's full width (``--layers`` deep, the
``--slots``/``--max-len``/``--page-size``/``--chunk-steps``/
``--prefill-chunk`` of the engine) and ``--json FILE`` writes the
reference's stats and the port's for each graph and level, which
``chip_smoke.py`` phase 12 reads.

Run (the port's device defaults to the card):

    PYTHONPATH=src python scripts/check_torch_parity.py --device cpu
    PYTHONPATH=src python scripts/check_torch_parity.py --device cpu \
        --width dh128
    PYTHONPATH=src python scripts/check_torch_parity.py --kind tp
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

# per-kind minimum fusion hit counts (rotary+QKV only matches the batch
# rope tables of the train/prefill paths; decode/serve and the paged
# graphs use per-row or sliced tables the compound rejects); the train
# step holds the train graph's forward, so its counts are the same
EXPECTED = {
    "train": {"swiglu": 1, "norm_matmul": 1, "rotary_qkv": 1},
    "train_step": {"swiglu": 1, "norm_matmul": 1, "rotary_qkv": 1},
    "prefill": {"swiglu": 1, "norm_matmul": 1, "rotary_qkv": 1},
    "decode": {"swiglu": 1, "norm_matmul": 1},
    "serve": {"swiglu": 1, "norm_matmul": 1},
    "paged_chunk": {"swiglu": 1, "norm_matmul": 1},
    "paged_prefill": {"swiglu": 1, "norm_matmul": 1},
}
# the other families' graph kinds and theirs (the reference's O2 forms
# the same at both widths): the architecture, then kind -> counts
FAMILIES = {
    "moe": ("mixtral-8x22b", {
        "train": {"norm_matmul": 1, "rotary_qkv": 1},
        "prefill": {"norm_matmul": 2, "rotary_qkv": 1},
        "decode": {"norm_matmul": 3},
        "long_decode": {"norm_matmul": 3},
    }),
    "mla_moe": ("deepseek-v3-671b", {
        "train": {"swiglu": 3, "norm_matmul": 17},
        "prefill": {"swiglu": 2, "norm_matmul": 10},
        "decode": {"swiglu": 2, "norm_matmul": 6},
    }),
    "rg_hybrid": ("recurrentgemma-9b", {
        "train": {"swiglu": 5, "norm_matmul": 9, "rotary_qkv": 1},
        "prefill": {"swiglu": 5, "norm_matmul": 10, "rotary_qkv": 1},
        "decode": {"swiglu": 5, "norm_matmul": 11},
        "long_decode": {"swiglu": 5, "norm_matmul": 11},
    }),
    "xlstm": ("xlstm-350m", {
        "train": {"norm_matmul": 5},
        "prefill": {"norm_matmul": 4},
        "decode": {"norm_matmul": 4},
        "long_decode": {"norm_matmul": 4},
    }),
    # LayerNorm and a GeLU MLP: no compound of the three forms
    "encdec": ("whisper-medium", {"train": {}, "prefill": {}, "decode": {}}),
    "vlm": ("llama-3.2-vision-11b", {
        "train": {"swiglu": 6, "norm_matmul": 2, "rotary_qkv": 5},
        "prefill": {"swiglu": 6, "norm_matmul": 11, "rotary_qkv": 5},
        "decode": {"swiglu": 6, "norm_matmul": 16},
    }),
}
# the graph kinds that hold an Attention op, which the flash kernel
# carries at the head widths the emitter offers it; the others attend
# through IR compositions
ATTENTION_KINDS = ("train", "train_step", "prefill", "decode", "long_decode")
# max_len, batch, and the paged graphs' shape: n_pages and max_len cover
# every page id and position below 100 that make_args may draw
MAX_LEN, BATCH = 16, 2
PAGED_MAX_LEN, PAGE_SIZE, N_PAGES, STEPS, CHUNK = 128, 8, 100, 2, 16
# the update's direction in L2 over its own norm: AdamW scales a gradient
# element to about +-lr, so an element whose bf16 rounding crosses zero
# flips its whole update (tests/test_torch_train.py holds the same)
UPDATE_L2 = {"f32": 1e-4, "bf16": 0.25}
WIDTHS = {"reduced": {},
          "dh128": dict(d_model=256, n_heads=2, n_kv_heads=2, d_head=128,
                        d_ff=256)}
# MLA's heads at the d_head-128 width: the prefill's d_nope + d_rope and
# the absorbed decode's kv_lora + d_rope are both 128 wide
MLA_DH128 = dict(d_nope=64, d_rope=64, d_v=128, kv_lora=64)


def family_config(get_config, arch: str, width: str):
    """``arch`` reduced, at ``width``.  The other families compute in
    f32.  In bf16 a MoE router whose k-th and (k+1)-th probabilities lie
    within a rounding of each other picks a different expert in two
    correct implementations (JAX against the reference's own numpy
    interpreter does so too), and the layer's output moves by a whole
    expert's share; ``tests/test_torch_moe.py`` holds bf16 to JAX with
    both packages on JAX's routing.  A recurrence carries one step's
    bf16 rounding into every later step, and an f32 state computed from
    bf16 values (rg's RG-LRU h, xlstm's seven) is no closer than bf16
    allows, so this gate's f32 tolerance for f32 outputs cannot hold
    them; ``tests/test_torch_recurrent.py`` and ``test_torch_xlstm.py``
    hold bf16 to JAX at 3e-2 of scale."""
    cfg = get_config(arch)
    over = dict(WIDTHS[width])
    if cfg.mla and width == "dh128":
        over.update(MLA_DH128)
    if cfg.family != "dense":
        over["compute_dtype"] = "f32"
    return cfg.reduced(**over)


def build(lm, shape_config, cfg, kind, train_graph=None):
    """One graph of ``kind``, built by the package whose ``models.lm``,
    ``ShapeConfig`` and ``models.train_graph`` are ``lm``,
    ``shape_config`` and ``train_graph``; returns ``(graphs, fn)``."""
    if kind == "train_step":
        g = lm.build_graphs(cfg, shape_config("train", "train", MAX_LEN,
                                              BATCH), BATCH)
        return g, train_graph.make_train_step(g, cfg).fn
    g = _build(lm, shape_config, cfg, kind)
    return g, g.fn


def _build(lm, shape_config, cfg, kind):
    if kind == "paged_chunk":
        return lm.build_dense_chunk(cfg, PAGED_MAX_LEN, BATCH, STEPS,
                                    page_size=PAGE_SIZE, n_pages=N_PAGES)
    if kind == "paged_prefill":
        return lm.build_dense_paged_prefill(cfg, PAGED_MAX_LEN, CHUNK,
                                            page_size=PAGE_SIZE,
                                            n_pages=N_PAGES)
    return lm.build_graphs(cfg, shape_config(kind, kind, MAX_LEN, BATCH),
                           BATCH)


def make_args(g, fn, cfg, rng):
    """``fn``'s inputs: the builder's seeded weights by name, a decode
    step's scalar position inside its cache (``MAX_LEN`` rows: past them
    a sliding window masks every key, where the flash kernel gives 0 and
    the plain composition the mean of V), other integer inputs below
    ``min(vocab, 100)``, float inputs (the AdamW moments of a train step
    among them) zero."""
    params = g.builder.init_params(0)
    args = []
    for node in fn.parameters:
        t = node.out_types[0]
        if node.name in params:
            args.append(params[node.name])
        elif node.name == "pos" and t.shape == ():
            args.append(rng.integers(0, MAX_LEN, size=()).astype(
                str(t.dtype)))
        elif "int" in str(t.dtype):
            args.append(rng.integers(
                0, min(cfg.vocab, 100), size=t.shape).astype(str(t.dtype)))
        else:
            args.append(np.zeros(t.shape, str(t.dtype)))
    return args


def compare(where, a, b, vocab, errors, tol=None):
    """``b`` (torch) against ``a`` (JAX); ``tol`` None takes the output
    dtype's tolerance, ``vocab`` None skips the logits rule."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        errors.append(f"{where}: {b.shape} {b.dtype} against JAX's "
                      f"{a.shape} {a.dtype}")
        return
    if a.dtype.kind in "iub":
        if not np.array_equal(a, b):
            errors.append(f"{where}: integer outputs differ")
        return
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    # bf16 storage: one ulp of headroom on top of accumulated error
    if tol is None:
        tol = 3e-2 if "bfloat16" in str(a.dtype) else 1e-4
    scale = max(float(np.abs(af).max()), 1.0)
    diff = float(np.abs(af - bf).max())
    if diff > tol * scale:
        errors.append(f"{where}: max |jax - torch| = {diff:.3e} "
                      f"(tol {tol * scale:.3e})")
    # logits: greedy parity.  The reference's rule finds logits by a last
    # dim over 100, which at d_head 128 also takes the KV caches, whose
    # head-dim argmax means nothing; the vocabulary names them exactly
    if vocab is not None and af.ndim >= 2 and af.shape[-1] == vocab:
        if not np.array_equal(af.argmax(-1), bf.argmax(-1)):
            errors.append(f"{where}: greedy argmax differs")


def required_kernels(kind: str, cfg) -> List[str]:
    from repro_torch.devices import torch_dtype
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import smoke_kernels
    need, _ = smoke_kernels(cfg, attention=kind in ATTENTION_KINDS,
                            train=kind == "train_step")
    # the dense and moe train loss graphs' one NormMatmul is the final
    # norm and the unembedding, which the kernels' shape rule refuses at
    # the reduced vocabulary (257); the train step's backward forms
    # others, and MLA's q and kv norms and the recurrent families' block
    # norms feed their projections
    if kind == "train" and cfg.family in ("dense", "moe") and \
            not ops.norm_matmul_supported(
                BATCH * MAX_LEN, cfg.d_model, cfg.vocab,
                torch_dtype(cfg.compute_dtype)):
        need.discard("norm_matmul")
    # a train graph normalizes every position, so its final norm fuses
    # with the unembedding too; every other xlstm norm feeds a
    # projection, which leaves its train graph no RMSNorm op
    if kind == "train" and cfg.family == "xlstm":
        need.discard("rmsnorm")
    return sorted(need)


def _rel_l2(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def compare_train_state(where, given, ref, outs, dtype, errors):
    """The train step's new state ``outs[1:]`` (p', m', v') against JAX's
    ``ref[1:]`` beyond ``compare``: each moment within the compute
    dtype's tolerance of its own norm, each update ``p' - p`` (``given``
    the step's p) in norm ratio within that tolerance and in direction
    within ``UPDATE_L2``."""
    tol = 3e-2 if dtype == "bf16" else 1e-4
    n = len(given)
    for i in range(n):
        p = np.asarray(given[i], np.float64)
        d_ref = np.asarray(ref[1 + i], np.float64) - p
        d_got = np.asarray(outs[1 + i], np.float64) - p
        ratio = float(np.linalg.norm(d_got) / np.linalg.norm(d_ref))
        err = _rel_l2(d_ref, d_got)
        if abs(ratio - 1) > tol or err > UPDATE_L2[dtype]:
            errors.append(f"{where}: update {i}: norm ratio {ratio:.6f}, "
                          f"L2 {err:.3e} (limits {tol}, {UPDATE_L2[dtype]})")
        for kind, j in (("m", 1 + n + i), ("v", 1 + 2 * n + i)):
            err = _rel_l2(ref[j], outs[j])
            if err > tol:
                errors.append(f"{where}: {kind} {i}: L2 {err:.3e} of its "
                              f"norm (tol {tol})")


TP_KINDS = ("paged_chunk", "paged_prefill")
TP_LEVELS = ("O1", "O2")
FUSE_ALL = {"swiglu": True, "norm_matmul": True, "rotary_qkv": True}


def tp_graphs(lm, cfg, shape: dict) -> dict:
    """The paged chunk and paged prefill graphs of ``shape`` built by the
    package whose ``models.lm`` is ``lm``."""
    mp = -(-shape["max_len"] // shape["page_size"])
    n_pages = 1 + shape["slots"] * mp
    return {
        "paged_chunk": lm.build_dense_chunk(
            cfg, shape["max_len"], shape["slots"], shape["chunk_steps"],
            page_size=shape["page_size"], n_pages=n_pages).fn,
        "paged_prefill": lm.build_dense_paged_prefill(
            cfg, shape["max_len"], shape["prefill_chunk"],
            page_size=shape["page_size"], n_pages=n_pages).fn}


def tp_partition_stats(tp: int, cfgs, shape: dict, errors: List[str]
                       ) -> dict:
    """``{"<kind>/<level>": {"reference": stats, "port": stats,
    "signature_equal": bool}}`` of each tp graph, partitioned over ``tp``
    shards by both packages' PartitionGraph with the port's ``tp``
    profile; a signature or stats mismatch is added to ``errors``."""
    from repro.core.passes import PartitionGraph as JPartitionGraph
    from repro.core.passes import run_pipeline as j_run_pipeline
    from repro.models import lm as j_lm
    from repro_torch.backend.sharding import partition_profile
    from repro_torch.core.passes import PartitionGraph, run_pipeline
    from repro_torch.models import lm as t_lm

    prof = partition_profile("tp")
    sizes = prof.axis_sizes((tp,))
    jcfg, tcfg = cfgs
    jgs, tgs = tp_graphs(j_lm, jcfg, shape), tp_graphs(t_lm, tcfg, shape)
    out = {}
    for kind in TP_KINDS:
        for level in TP_LEVELS:
            where = f"tp={tp} {kind} {level}"
            jfn, jrep = j_run_pipeline(
                jgs[kind], level, fuse=FUSE_ALL,
                partition=JPartitionGraph(prof.rules, sizes,
                                          prof.last_dim_only, prof.anywhere))
            tfn, trep = run_pipeline(
                tgs[kind], level, fuse=FUSE_ALL,
                partition=PartitionGraph.from_profile(prof, (tp,)))
            ref = dict(jrep.stats["partition"])
            got = dict(trep.stats["partition"])
            same = jfn.signature() == tfn.signature()
            if not same:
                errors.append(f"{where}: the partitioned graphs differ")
            if got != ref:
                errors.append(f"{where}: partition stats {got}, the "
                              f"reference's {ref}")
            out[f"{kind}/{level}"] = {"reference": ref, "port": got,
                                      "signature_equal": same}
            print(f"{where}: signature {'equal' if same else 'DIFFERS'}, "
                  f"stats {got} (reference {ref})")
    return out


def main_tp(args) -> int:
    import dataclasses
    import json

    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config

    if args.tp_width == "full":
        cfgs = tuple(dataclasses.replace(g("deepseek-7b"),
                                         n_layers=args.layers)
                     for g in (j_get_config, get_config))
        shape = dict(slots=args.slots, max_len=args.max_len,
                     page_size=args.page_size, chunk_steps=args.chunk_steps,
                     prefill_chunk=args.prefill_chunk)
    else:
        cfgs = tuple(g("deepseek-7b").reduced()
                     for g in (j_get_config, get_config))
        shape = dict(slots=BATCH, max_len=PAGED_MAX_LEN,
                     page_size=PAGE_SIZE, chunk_steps=STEPS,
                     prefill_chunk=CHUNK)
    errors: List[str] = []
    out = tp_partition_stats(args.tp, cfgs, shape, errors)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"tp": args.tp, "width": args.tp_width,
                       "layers": cfgs[1].n_layers, "shape": shape,
                       "graphs": out, "errors": errors}, f, indent=1)
    if errors:
        for e in errors:
            print(f"PARITY FAIL: {e}", file=sys.stderr)
        return 1
    print(f"torch tp parity ok (tp={args.tp}, {args.tp_width} width): the "
          f"partitioned paged graphs' signatures and stats equal the "
          f"reference's at O1 and O2")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=("all", "graphs", "tp"),
                    default="all",
                    help="graphs: every graph kind against JAX; tp: the "
                         "partition pass against the reference's; all: "
                         "both")
    ap.add_argument("--tp", type=int, default=2,
                    help="tp kind: shards of the partition")
    ap.add_argument("--tp-width", choices=("reduced", "full"),
                    default="reduced",
                    help="tp kind: reduced deepseek-7b at this script's "
                         "paged shapes, or full width at the engine "
                         "shape the flags below give")
    ap.add_argument("--layers", type=int, default=30)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk-steps", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="tp kind: write the stats here")
    ap.add_argument("--device", default="cuda",
                    help="the torch side's device: 'cuda', 'cuda:i' or "
                         "'cpu' (default: the card)")
    ap.add_argument("--width", choices=sorted(WIDTHS), default="reduced",
                    help="reduced deepseek-7b as it stands, or at d_head "
                         "128 (d_model 256, 2 heads), where the flash "
                         "kernel carries the Attention op")
    args = ap.parse_args(argv)
    if args.kind == "tp":
        return main_tp(args)
    if args.kind == "all" and main_tp(args):
        return 1

    from repro.backend import Backend as JBackend
    from repro.backend import CompileOptions as JOptions
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.models import lm as j_lm
    from repro.models import train_graph as j_train
    from repro_torch import kernels
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm as t_lm
    from repro_torch.models import train_graph as t_train

    jbe = JBackend.create("jax")
    tbe = Backend.create("torch", device=args.device)
    on_card = tbe.device.type == "cuda"
    rng = np.random.default_rng(0)
    errors: List[str] = []
    runs = [("deepseek-7b", "", EXPECTED)] + [
        (arch, f"{arch} ", kinds) for arch, kinds in FAMILIES.values()]
    for arch, label, kinds in runs:
        jcfg = family_config(j_get_config, arch, args.width)
        tcfg = family_config(get_config, arch, args.width)
        train_tol = 3e-2 if tcfg.compute_dtype == "bf16" else 1e-4
        for kind, expected in kinds.items():
            where = f"{label}{kind}"
            jg, jfn = build(j_lm, JShapeConfig, jcfg, kind, j_train)
            tg, tfn = build(t_lm, ShapeConfig, tcfg, kind, t_train)
            if jfn.signature() != tfn.signature():
                errors.append(f"{where}: the two packages built different "
                              f"graphs")
                continue
            args_np = make_args(jg, jfn, jcfg, rng)
            ref = jbe.compile(jfn, JOptions(level="O1"))(*args_np)
            o1 = tbe.compile(tfn, CompileOptions(level="O1"))(*args_np)
            fused = tbe.compile(tfn, CompileOptions(level="O2",
                                                    use_pallas=True))
            kernels.reset_counters()
            o2 = fused(*args_np)
            counts = kernels.counters()
            hits = dict(fused.report.stats).get("fuse-compounds", {})
            for compound, n in expected.items():
                if hits.get(compound, 0) < n:
                    errors.append(f"{where}: expected >= {n} {compound} "
                                  f"fusions, got {hits.get(compound, 0)} "
                                  f"(hits: {hits})")
            for level, outs in (("O1", o1), ("O2", o2)):
                if len(outs) != len(ref):
                    errors.append(f"{where} {level}: {len(outs)} outputs, "
                                  f"JAX gives {len(ref)}")
                    continue
                for i, (a, b) in enumerate(zip(ref, outs)):
                    compare(f"{where} torch {level} output {i}", a, b,
                            None if kind == "train_step" else tcfg.vocab,
                            errors, tol=train_tol if kind.startswith("train")
                            else None)
                if kind == "train_step" and len(outs) == len(ref):
                    n = (len(ref) - 1) // 3
                    compare_train_state(f"{where} torch {level}",
                                        args_np[-3 * n:-2 * n], ref, outs,
                                        tcfg.compute_dtype, errors)
            launched = {k: c["launches"] for k, c in counts.items()}
            if on_card:
                for name in required_kernels(kind, tcfg):
                    if launched[name] == 0:
                        errors.append(f"{where}: kernel {name} never "
                                      f"launched on the card ({counts})")
            shown = {k: v for k, v in hits.items() if v}
            print(f"{where}: fused {shown}, torch O1 and O2 match JAX O1 "
                  f"on {tbe.device}; launches {launched}")
    if errors:
        for e in errors:
            print(f"PARITY FAIL: {e}", file=sys.stderr)
        return 1
    print(f"torch parity ok ({args.width}, {tbe.device}): O1 and O2 "
          f"(kernels) match JAX O1 on every graph kind of the dense, moe, "
          f"mla_moe, rg_hybrid, xlstm, encdec and vlm families")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
