"""Buffer probe on torch: compile one dry-run cell and census its largest
per-shard values (the port of ``scripts/probe_buffers.py``; imports only
``repro_torch``, needs no card).

``python scripts/torch_probe_buffers.py ARCH SHAPE [VJP]``
(defaults ``qwen1.5-110b train_4k auto``) compiles the cell as
``repro_torch.launch.dryrun`` does -- the pjit glue's specs on the
``hgx32x8`` meta mesh, the partition pass under the arch's profile, the
attention VJP set first (``core.autodiff.set_attention_vjp``) -- and
prints:

  * the memory plan of the partitioned function on the reference's
    ``temp= args= out=`` line: ``temp`` is the plan's ``peak_live_bytes``
    (the live intermediates), ``args`` and ``out`` split its
    ``io_bytes`` into the parameters and constants and the outputs.  The
    plan counts the top level's values only: temporaries inside Scan
    bodies are not in it (``alias``, XLA's donated-buffer reuse, has no
    counterpart);
  * the 25 largest per-shard values of the partitioned IR, Scan bodies
    included (each body once, as HLO text lists a loop body once), by
    op and ``dtype[shape]``, with their count and GiB.

The reference reads XLA's ``memory_analysis()`` and the optimized HLO;
the port has no HLO, and its partitioned IR is what the shard executor
runs.
"""
from __future__ import annotations

import os
import sys
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

TOP = 25
# HLO's names for the IR's dtypes, as the reference's census prints them
HLO_DTYPE = {"bool": "pred", "int8": "s8", "uint8": "u8", "bfloat16": "bf16",
             "float16": "f16", "int32": "s32", "uint32": "u32",
             "float32": "f32", "int64": "s64", "float64": "f64"}


def value_census(fn) -> dict:
    """(op, "dtype[shape]") -> [count, bytes of one] over every value of
    ``fn`` and of the Scan bodies inside it."""
    sizes = defaultdict(lambda: [0, 0])

    def walk(f):
        for node in f.nodes():
            if node.op == "Scan":
                walk(node.attrs["body"])
            for t in node.out_types:
                dt = HLO_DTYPE.get(str(t.dtype), str(t.dtype))
                key = (node.op, f"{dt}[{','.join(map(str, t.shape))}]")
                sizes[key][0] += 1
                sizes[key][1] = t.nbytes
    walk(fn)
    return dict(sizes)


def probe(arch: str, shape_name: str, vjp: str = "auto") -> dict:
    from repro_torch.core import autodiff
    autodiff.set_attention_vjp(vjp)

    from repro_torch.backend.sharding import make_production_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import compile_cell

    cf, _fn, _graphs, _ins = compile_cell(get_config(arch), SHAPES[shape_name],
                                          make_production_mesh())
    part = cf.function
    plan = cf.memory_plan
    out = sum(t.nbytes for t in part.out_types)
    print(f"temp={plan.peak_live_bytes / 2**30:.1f}GiB "
          f"args={(plan.io_bytes - out) / 2**30:.1f}GiB "
          f"out={out / 2**30:.1f}GiB alias=n/a "
          f"(memory plan of the partitioned function: temp = "
          f"peak_live_bytes, args + out = io_bytes; Scan-body temporaries "
          f"are not in the plan)")
    sizes = value_census(part)
    top = sorted(sizes.items(), key=lambda kv: -kv[1][1])[:TOP]
    print("\nlargest per-shard values of the partitioned IR "
          "(Scan bodies included):")
    for (op, ty), (cnt, b) in top:
        print(f"  {b / 2**30:8.2f} GiB x{cnt:<4d} {op:24s} {ty}")
    return {"plan": plan, "top": top}


if __name__ == "__main__":
    probe(sys.argv[1] if len(sys.argv) > 1 else "qwen1.5-110b",
          sys.argv[2] if len(sys.argv) > 2 else "train_4k",
          sys.argv[3] if len(sys.argv) > 3 else "auto")
