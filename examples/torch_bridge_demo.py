"""Framework bridges (paper sec. 3) on torch: the same model through three
frontends -- neon-style layers, the functional builder, and a serialized
graph import -- compiled by the same backends (the counterpart of
``examples/bridge_demo.py``).

    PYTHONPATH=src python examples/torch_bridge_demo.py [--device cpu]

Runs on the card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import ng  # noqa: E402
from repro_torch.backend import Backend, available_backends  # noqa: E402
from repro_torch.bridges import neon, onnx_like  # noqa: E402
from repro_torch.core import Function  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="'cuda', 'cuda:i' or 'cpu' (default: the card)")
device = ap.parse_args().device

rng = np.random.default_rng(0)

# Frontend 1: neon-style layer objects (the bridge owns the params)
net = neon.Sequential([
    neon.Dense(32, 64, activation="tanh", name="fc1", seed=1),
    neon.RMSNormLayer(64, name="norm"),
    neon.Dense(64, 10, name="fc2", seed=2),
])
model = neon.Model(net)
fn_neon, names = neon.bridge_to_ir(model, (4, 32))

# Frontend 2: the functional builder, same math
x = ng.parameter((4, 32), "f32", "input")
params = {n: ng.parameter(model.param_values[n].shape, "f32", n) for n in names}
h = ng.tanh(ng.matmul(x.out(), params["fc1/w"].out()) + params["fc1/b"].out())
h = ng.rms_norm(h, params["norm/g"].out())
y = ng.matmul(h, params["fc2/w"].out()) + params["fc2/b"].out()
fn_func = Function([x] + [params[n] for n in names], [y])

# Frontend 3: a serialized graph from a foreign producer
fn_import = onnx_like.import_graph(onnx_like.export_graph(fn_neon))

inp = rng.normal(size=(4, 32)).astype(np.float32)
args = [inp] + [model.param_values[n] for n in names]


def host(t):
    return t.detach().float().cpu().numpy() if hasattr(t, "detach") \
        else np.asarray(t)


print("backends:", available_backends())
for be in (Backend.create("interpreter"),
           Backend.create("torch", device=device)):
    outs = [host(be.compile(f)(*args)[0])
            for f in (fn_neon, fn_func, fn_import)]
    print(f"{be.name:12s} neon-vs-func {np.abs(outs[0]-outs[1]).max():.2e}  "
          f"neon-vs-import {np.abs(outs[0]-outs[2]).max():.2e}")
print("one IR, three frontends, two backends: identical numerics.")
