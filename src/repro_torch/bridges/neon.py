"""neon-style framework bridge.

The paper (sec. 3): "For neon, we are creating a Python binding for the
nGraph API".  This module is a miniature layer-object framework (the kind
of API neon exposed) whose *backend is the bridge*: ``bridge_to_ir`` walks
the layer graph and emits nGraph IR; training graphs come from IR autodiff
(sec. 3: bridges use "autodiff on the nGraph IR for the derivative").
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import ops
from ..core.autodiff import GradBuilder, zeros_of
from ..core.function import Function
from ..core.node import Node, Value


class Layer:
    """A stateful layer object (framework side — state lives here, not in
    the stateless IR)."""

    def params(self) -> Dict[str, np.ndarray]:
        return {}

    def build(self, x: Value, get_param) -> Value:
        raise NotImplementedError


class Dense(Layer):
    def __init__(self, n_in: int, n_out: int, activation: Optional[str] = None,
                 bias: bool = True, name: str = "dense", seed: int = 0):
        self.name = name
        rng = np.random.default_rng(seed)
        scale = 1.0 / math.sqrt(n_in)
        self._params = {f"{name}/w": (rng.normal(size=(n_in, n_out)) * scale).astype(np.float32)}
        if bias:
            self._params[f"{name}/b"] = np.zeros((n_out,), np.float32)
        self.activation = activation
        self.bias = bias

    def params(self):
        return self._params

    def build(self, x: Value, get_param) -> Value:
        y = ops.matmul(x, get_param(f"{self.name}/w"))
        if self.bias:
            y = y + get_param(f"{self.name}/b")
        if self.activation:
            y = getattr(ops, self.activation)(y)
        return y


class Embedding(Layer):
    def __init__(self, vocab: int, dim: int, name: str = "emb", seed: int = 0):
        self.name = name
        rng = np.random.default_rng(seed)
        self._params = {f"{name}/table": (rng.normal(size=(vocab, dim)) * 0.02).astype(np.float32)}

    def params(self):
        return self._params

    def build(self, x: Value, get_param) -> Value:
        return ops.gather(get_param(f"{self.name}/table"), x, axis=0)


class RMSNormLayer(Layer):
    def __init__(self, dim: int, name: str = "rmsnorm"):
        self.name = name
        self._params = {f"{name}/g": np.ones((dim,), np.float32)}

    def params(self):
        return self._params

    def build(self, x: Value, get_param) -> Value:
        return ops.rms_norm(x, get_param(f"{self.name}/g"))


class LayerNormLayer(Layer):
    def __init__(self, dim: int, name: str = "layernorm"):
        self.name = name
        self._params = {f"{name}/g": np.ones((dim,), np.float32),
                        f"{name}/b": np.zeros((dim,), np.float32)}

    def params(self):
        return self._params

    def build(self, x: Value, get_param) -> Value:
        return ops.layer_norm(x, get_param(f"{self.name}/g"), get_param(f"{self.name}/b"))


class Sequential(Layer):
    def __init__(self, layers: Sequence[Layer]):
        self.layers = list(layers)

    def params(self):
        out = {}
        for l in self.layers:
            out.update(l.params())
        return out

    def build(self, x: Value, get_param) -> Value:
        for l in self.layers:
            x = l.build(x, get_param)
        return x


class Model:
    """Framework-side model: owns parameter arrays + a layer graph."""

    def __init__(self, net: Layer):
        self.net = net
        self.param_values: Dict[str, np.ndarray] = dict(net.params())

    def param_names(self) -> List[str]:
        return sorted(self.param_values)


def bridge_to_ir(
    model: Model,
    input_shape: Sequence[int],
    input_dtype="f32",
    loss: Optional[str] = None,
    label_shape: Optional[Sequence[int]] = None,
    with_grads: bool = False,
) -> Tuple[Function, List[str]]:
    """Translate the framework graph to an nGraph Function.

    Returns (function, param_order): function params are
    [input, (labels), *params-in-order].  With ``with_grads``, results are
    [loss/output, *grads] computed by autodiff on the IR.
    """
    names = model.param_names()
    x_p = ops.parameter(input_shape, input_dtype, "input")
    label_p = None
    if loss is not None:
        if label_shape is None:
            raise ValueError("loss needs label_shape")
        label_p = ops.parameter(label_shape, "i32", "labels")
    param_nodes = {n: ops.parameter(model.param_values[n].shape,
                                    model.param_values[n].dtype, n)
                   for n in names}

    def get_param(n: str) -> Value:
        return param_nodes[n].out()

    out = model.net.build(x_p.out(), get_param)
    all_params = [x_p] + ([label_p] if label_p else []) + [param_nodes[n] for n in names]
    if loss is None:
        return Function(all_params, [out], name="neon_forward"), names
    if loss == "softmax_xent":
        loss_v = ops.reduce_mean(ops.softmax_cross_entropy(out, label_p.out()))
    elif loss == "mse":
        diff = out - ops.convert(label_p.out(), out.dtype)
        loss_v = ops.reduce_mean(diff * diff)
    else:
        raise ValueError(f"unknown loss {loss}")
    if not with_grads:
        return Function(all_params, [loss_v, out], name="neon_loss"), names
    gb = GradBuilder()
    wrt = [param_nodes[n].out() for n in names]
    grads = gb.backprop([loss_v], [ops.constant(1.0, dtype=loss_v.dtype)], wrt)
    grads = [g if g is not None else zeros_of(v.type) for g, v in zip(grads, wrt)]
    fn = Function(all_params, [loss_v] + grads, name="neon_train")
    return gb.apply_replacements(fn), names


def compile_model(
    model: Model,
    input_shape: Sequence[int],
    *,
    input_dtype="f32",
    loss: Optional[str] = None,
    label_shape: Optional[Sequence[int]] = None,
    with_grads: bool = False,
    backend: str = "torch",
    options=None,
    device=None,
):
    """Bridge ``model`` to IR and compile it on a named backend.

    The neon-style one-call path the paper describes for framework users:
    the bridge emits IR and hands it to the unified Backend API (pipeline,
    kernel selection, and the compile cache all happen behind it).
    Returns ``(compiled, param_order)`` where ``compiled`` is a
    :class:`repro_torch.backend.CompiledFunction`.  The torch backend
    runs on the card unless ``device`` names another ('cpu').
    """
    from ..backend import Backend, CompileOptions
    fn, names = bridge_to_ir(model, input_shape, input_dtype=input_dtype,
                             loss=loss, label_shape=label_shape,
                             with_grads=with_grads)
    be = Backend.create(backend, **({} if device is None
                                    else {"device": device}))
    compiled = be.compile(fn, options or CompileOptions())
    return compiled, names
