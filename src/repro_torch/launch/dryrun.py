"""Multi-pod dry run on torch: compile every (arch x shape) on the
production meshes without a card and record memory, cost and collectives
(the port of ``repro/launch/dryrun.py``).

A cell builds the arch's graph at published widths (the train step for
train shapes), takes its specs from the pjit glue, compiles it with
``CompileOptions(mode="pjit", mesh=<meta production mesh>,
in_shardings=...)`` on the meta device -- the PartitionGraph pass under
the arch's profile, then the shard executor's plan -- and walks shard 0
of that plan on meta tensors, which must reach outputs of the IR's
shapes: the counterpart of ``.compile()`` succeeding.  The meshes are
``hgx32x8`` (32 HGX nodes of 8 H100s, ``(data, model)``) and
``hgx2x32x8`` (two such pods; the pass sees pod x data as one axis,
``sharding.fold_pods``).  Results land in
``results/dryrun_torch/<mesh>/<arch>__<shape>.json``: the reference's
record (``Roofline.to_dict()`` and the rest) plus the pass's stats and
the gathers its fallback inserted.  Per-device memory is the IR's
liveness plan of the partitioned function (``peak_live_bytes +
io_bytes``), which does not count Scan bodies' temporaries.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b \\
      --shape train_4k [--multi-pod] [--both-meshes] [--all]

``--licm`` (an XLA pass switch) has no counterpart.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import List, Optional


def _cell(arch: str, shape_name: str, multi_pod: bool, attn_impl: str = "auto",
          out_dir: str = "results/dryrun_torch", remat: bool = False,
          force: bool = False, save: bool = True,
          attn_vjp: str = "auto", n_micro: int = 1,
          cfg=None, mesh=None) -> Optional[dict]:
    """One dry-run cell.  ``cfg`` (default: the arch's published config)
    and ``mesh`` (default: the production mesh, meta devices) let a
    caller cut the cell down."""
    import torch

    from ..core import autodiff
    autodiff.set_attention_vjp(attn_vjp)

    from ..backend import Backend, CompileOptions
    from ..backend.sharding import (fold_pods, graph_shardings,
                                    make_production_mesh, mesh_axis_sizes,
                                    pods_replicate, production_mesh_name,
                                    profile_for_arch, train_step_shardings)
    from ..configs import get_config
    from ..configs.base import SHAPES, supported_shapes
    from ..core.cost import function_cost
    from ..core.passes.partition import fallback_gathers
    from ..devices import torch_dtype
    from ..models.lm import build_graphs
    from ..models.train_graph import make_train_step
    from .roofline import Roofline, census_collectives, model_flops_for

    mesh_name = (production_mesh_name(multi_pod) if mesh is None else
                 "x".join(str(s) for s in mesh.devices.shape))
    tag = f"{arch.replace('/', '_')}__{shape_name}"
    out_path = os.path.join(out_dir, mesh_name, f"{tag}.json")
    if save and not force and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    if shape not in supported_shapes(cfg):
        print(f"[skip] {arch} x {shape_name}: unsupported "
              f"(full-attention arch at 500k)")
        return None

    t0 = time.time()
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_dev = int(mesh.devices.size)
    mb = shape.global_batch // n_micro if shape.kind == "train" else \
        shape.global_batch
    graphs = build_graphs(cfg, shape, mb)
    backend = Backend.create("torch", device="meta")

    if shape.kind == "train":
        ts = make_train_step(graphs, cfg, n_micro=n_micro)
        ins, outs, donate, rules = train_step_shardings(ts, mesh)
        fn = ts.fn
        kw = dict(in_shardings=ins, out_shardings=outs,
                  donate_argnums=donate)
    else:
        ins, rules = graph_shardings(graphs, mesh)
        fn = graphs.fn
        kw = dict(in_shardings=ins)

    cf = backend.compile(fn, CompileOptions(
        mode="pjit", mesh=mesh, axis_rules=rules, attn_impl=attn_impl,
        partition=profile_for_arch(cfg.name), remat_scan=remat, **kw))
    t_build = time.time() - t0
    t_lower = cf.report.seconds
    args = [torch.empty(t.shape, dtype=torch_dtype(t.dtype), device="meta")
            for t in fn.in_types]
    t1 = time.time()
    got = cf.raw(*args)
    t_compile = t_build - t_lower + time.time() - t1
    for o, t in zip(got, fn.out_types):
        if tuple(o.shape) != t.shape or o.dtype != torch_dtype(t.dtype):
            raise AssertionError(f"{tag}: the walk gave {tuple(o.shape)} "
                                 f"{o.dtype}, the IR {t}")

    sizes = mesh_axis_sizes(fold_pods(mesh))
    census = census_collectives(cf.function, sizes)
    cost = cf.cost
    plan = cf.memory_plan
    peak_bytes = plan.peak_live_bytes + plan.io_bytes
    ir_cost = function_cost(fn, attn_impl="chunked")
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, n_devices=n_dev,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        ir_flops=ir_cost.flops, ir_bytes=ir_cost.bytes,
        collective_bytes=census.total_tpu_bytes,
        model_flops=model_flops_for(graphs.builder, cfg, shape.kind,
                                    shape.seq_len, shape.global_batch),
        collectives=census.counts,
        coll_bytes_by_kind=census.bytes_by_kind,
        per_device_memory=float(peak_bytes),
        coll_bytes_by_axis=census.bytes_by_axis,
    )
    rec = rl.to_dict()
    rec.update({
        "collective_bytes_as_compiled": census.total_bytes,
        "n_params": graphs.builder.n_params(),
        "graph_nodes": len(fn.nodes()),
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "attn_impl": attn_impl,
        "n_micro": n_micro,
        "hlo_collective_lines": sum(census.nodes.values()),
        "collective_nodes": census.nodes,
        "collective_bytes_by_axis": census.bytes_by_axis,
        "partition": dict(cf.report.stats["partition"]),
        "fallback_gathers": fallback_gathers(cf.function),
        "pass_mesh": sizes,
        "pods_replicate": pods_replicate(ins, fn.parameters),
        "memory_plan": {"peak_live_bytes": plan.peak_live_bytes,
                        "io_bytes": plan.io_bytes,
                        "scan_body_temporaries": "not counted"},
    })
    print(f"[ok] {mesh_name} {tag}: compile={t_compile:.0f}s "
          f"mem/dev={peak_bytes / 2**30:.2f}GiB "
          f"flops/dev={rl.hlo_flops:.3g} "
          f"t=(c {rl.t_compute:.3f}|m {rl.t_memory:.3f}|x {rl.t_collective:.3f})s "
          f"bottleneck={rl.bottleneck} roofline={rl.roofline_fraction:.3f} "
          f"sharded={rec['partition'].get('params_sharded', 0)} "
          f"gathers={rec['partition'].get('all_gather', 0)} "
          f"fallback={json.dumps(rec['fallback_gathers'], sort_keys=True)}",
          flush=True)
    if save:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attn-impl", default="auto")
    ap.add_argument("--attn-vjp", default="auto",
                    choices=["auto", "full", "chunked"])
    ap.add_argument("--n-micro", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import ARCHS
    from ..configs.base import SHAPES

    archs = args.arch or (ARCHS if args.all else ARCHS[:1])
    shapes = args.shape or list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                try:
                    _cell(a, s, mp, attn_impl=args.attn_impl,
                          out_dir=args.out_dir, force=args.force,
                          attn_vjp=args.attn_vjp, n_micro=args.n_micro)
                except Exception as e:  # record and continue
                    failures.append((a, s, mp, repr(e)))
                    print(f"[FAIL] {a} x {s} multi_pod={mp}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nDRY-RUN GREEN")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
