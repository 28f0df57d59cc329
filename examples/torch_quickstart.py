"""Quickstart on torch: build IR with the functional frontend, compile it
through the unified Backend API (pipeline + cache included), execute on
two backends, take gradients -- the whole nGraph pipeline on the port
(the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import ng                       # the functional IR frontend
from repro_torch.backend import Backend, CompileOptions  # noqa: E402
from repro_torch.core import Function            # noqa: E402
from repro_torch.core.autodiff import grad       # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="'cuda', 'cuda:i' or 'cpu' (default: the card)")
device = ap.parse_args().device


def host(t):
    """An output (a device tensor or a host array) as numpy."""
    return t.detach().float().cpu().numpy() if hasattr(t, "detach") \
        else np.asarray(t)


# 1. Build a graph: softmax(rms_norm(gelu(x @ w)) * g)
x = ng.parameter((8, 64), "f32", "x")
w = ng.parameter((64, 64), "f32", "w")
g = ng.parameter((64,), "f32", "g")
y = ng.softmax(ng.rms_norm(ng.gelu(ng.matmul(x.out(), w.out())), g.out()), -1)
fn = Function([x, w, g], [y])
print("graph:", fn)

# 2. One compile call runs the pass pipeline AND backend codegen.
#    CompileOptions is the single declarative knob set (opt level, kernel
#    selection, partitioning); the result carries the pipeline report.
torch_be = Backend.create("torch", device=device)
compiled = torch_be.compile(fn, CompileOptions(level="O2"))
print(compiled.report.summary())

# 3. The same IR compiles on every backend -- and executables support
#    positional or named-parameter calling.
rng = np.random.default_rng(0)
args = dict(x=rng.normal(size=(8, 64)).astype(np.float32),
            w=rng.normal(size=(64, 64)).astype(np.float32),
            g=np.ones(64, np.float32))
ref = Backend.create("interpreter").compile(fn)(**args)[0]
out = host(compiled(**args)[0])
print(f"interpreter vs torch on {torch_be.device} max|diff|:",
      np.abs(ref - out).max())

# 4. Compiles are memoized: a structurally-identical graph with the same
#    options is a cache hit (this is what keeps serving fast).
again = torch_be.compile(fn, CompileOptions(level="O2"))
assert again is compiled
print("compile cache:", torch_be.cache_stats())

# 5. Autodiff ON THE IR (not on traces): a gradient graph, same API
loss_fn = Function([x, w, g], [ng.reduce_mean(fn.results[0] * fn.results[0])])
gfn = grad(loss_fn)
print("grad graph:", len(gfn.nodes()), "nodes")
grads = torch_be.compile(gfn)(**args)
print("dL/dw norm:", float(np.square(host(grads[2])).sum()) ** 0.5)

# 6. Compile artifacts ride along as metadata: the memory plan (liveness
#    arena) and the IR-level cost estimate.
print("memory plan:", compiled.memory_plan.summary())
print("cost: %.3g flops, %.3g bytes" % (compiled.cost.flops,
                                        compiled.cost.bytes))
