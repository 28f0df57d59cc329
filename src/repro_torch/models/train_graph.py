"""Train-step construction: autodiff on the IR + AdamW-in-IR.

Paper sec. 3: bridges "use autodiff on the nGraph IR for the derivative".
``make_train_step`` takes a forward-loss Function produced by
``models.lm`` and returns one Function computing

    (data..., step, *params, *m, *v) -> (loss, *params', *m', *v')

entirely in IR: reverse-mode sweep (checkpoint-carries through Scan),
global-norm clipping, LR schedule (cosine / WSD / constant) evaluated on
the step scalar, decoupled weight decay.  The caller jits it with
donated param/state buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..core import ops
from ..core.autodiff import GradBuilder, zeros_of
from ..core.function import Function
from ..core.node import Node, Value
from .builder import ModelBuilder
from .lm import ModelGraphs


def lr_schedule(cfg: ModelConfig, step_f: Value) -> Value:
    """LR at ``step_f`` (scalar f32) as IR ops."""
    lr = ops.constant(cfg.lr, dtype="f32")
    one = ops.constant(1.0, dtype="f32")
    warm = ops.constant(float(max(cfg.warmup, 1)), dtype="f32")
    total = ops.constant(float(cfg.total_steps), dtype="f32")
    # step+1 so the first step trains at lr/warmup, not 0
    warm_frac = ops.minimum((step_f + one) / warm, one)
    if cfg.schedule == "constant":
        return lr * warm_frac
    if cfg.schedule == "wsd":
        # warmup -> stable -> linear decay over the last decay_frac steps
        decay_steps = ops.constant(
            float(max(int(cfg.total_steps * cfg.decay_frac), 1)), dtype="f32")
        into_decay = ops.maximum(step_f - (total - decay_steps),
                                 ops.constant(0.0, dtype="f32"))
        decay = ops.maximum(one - into_decay / decay_steps,
                            ops.constant(0.0, dtype="f32"))
        return lr * warm_frac * decay
    # cosine to 10% of peak
    prog = ops.minimum(ops.maximum((step_f - warm) / ops.maximum(total - warm, one),
                                   ops.constant(0.0, dtype="f32")), one)
    cos = ops.constant(0.5, dtype="f32") * \
        (one + ops.cos(prog * ops.constant(float(np.pi), dtype="f32")))
    floor = ops.constant(0.1, dtype="f32")
    return lr * warm_frac * (floor + (one - floor) * cos)


@dataclasses.dataclass
class TrainStep:
    fn: Function
    n_data_inputs: int     # tokens/labels/frames/... then `step`
    param_names: List[str]
    graphs: ModelGraphs

    @property
    def n_params(self) -> int:
        return len(self.param_names)


def _microbatch_grads(graphs: ModelGraphs, n_micro: int):
    """Gradient accumulation: scan the loss+grad graph over n_micro
    slices of the batch.  Returns (data_params, loss, grads) where
    data_params take the FULL global batch (reshaped to microbatch xs
    internally) — activation memory scales with batch/n_micro."""
    from ..core.autodiff import grad as build_grad

    b = graphs.builder
    mb_fn = build_grad(graphs.fn, keep_outputs=False)
    # mb_fn: (data_mb..., weights...) -> (loss, *grads)
    n_data = len(b.inputs)
    names = b.param_names()
    param_nodes = [b.params[n].node for n in names]

    # full-batch data inputs; reshape to (n_micro, mb, ...) scan xs
    data_params = []
    xs = []
    for node in b.inputs:
        t = node.out_types[0]
        full_shape = (t.shape[0] * n_micro,) + t.shape[1:]
        p = ops.parameter(full_shape, t.dtype, node.name)
        data_params.append(p)
        xs.append(ops.reshape(p.out(), (n_micro,) + t.shape))

    # scan body: inline mb_fn onto fresh params, accumulate loss + grads
    acc_params = [ops.parameter((), "f32", "loss_acc")]
    acc_params += [ops.parameter(p.out_types[0].shape, "f32", f"gacc{i}")
                   for i, p in enumerate(param_nodes)]
    x_params = [ops.parameter(n.out_types[0].shape, n.out_types[0].dtype,
                              n.name) for n in b.inputs]
    w_params = [ops.parameter(p.out_types[0].shape, p.out_types[0].dtype,
                              f"w{i}") for i, p in enumerate(param_nodes)]
    env = {}
    bind = [p.out() for p in x_params] + [p.out() for p in w_params]
    for mp, v in zip(mb_fn.parameters, bind):
        env[id(mp)] = [v]
    for n2 in mb_fn.nodes():
        if n2.op == "Parameter":
            continue
        ins = [env[id(v.node)][v.index] for v in n2.inputs]
        clone = Node(n2.op, ins, dict(n2.attrs), n2.out_types)
        env[id(n2)] = [clone.out(i) for i in range(clone.n_outputs)]

    def res(v):
        return env[id(v.node)][v.index] if id(v.node) in env else v

    mb_loss = ops.convert(res(mb_fn.results[0]), "f32")
    # grad() returns grads for every fn parameter (data first, then
    # weights); keep the weight grads only
    mb_grads = [ops.convert(res(r), "f32")
                for r in mb_fn.results[1 + n_data:]]
    body_res = [acc_params[0].out() + mb_loss] + \
        [a.out() + g for a, g in zip(acc_params[1:], mb_grads)]
    body = Function(acc_params + x_params + w_params, body_res,
                    name="micro_accum")
    inits = [ops.constant(0.0, dtype="f32")] + \
        [ops.broadcast_to(ops.constant(0.0, dtype="f32"), p.out_types[0].shape)
         for p in param_nodes]
    outs = ops.scan(body, inits, xs=xs,
                    consts=[p.out() for p in param_nodes], length=n_micro)
    inv = ops.constant(1.0 / n_micro, dtype="f32")
    loss = outs[0] * inv
    grads = [ops.convert(g * ops.broadcast_to(inv, g.shape),
                         p.out_types[0].dtype)
             for g, p in zip(outs[1:], param_nodes)]
    return data_params, loss, grads


def make_train_step(graphs: ModelGraphs, cfg: Optional[ModelConfig] = None,
                    b1: float = 0.9, b2: float = 0.95,
                    eps: float = 1e-8, n_micro: int = 1) -> TrainStep:
    """Wrap a forward-loss graph with IR autodiff + AdamW.

    ``n_micro > 1``: gradient accumulation — ``graphs`` must be built at
    batch = global_batch / n_micro; the step Function still takes the
    full global batch and scans microbatches (EXPERIMENTS.md Perf iter 8).
    """
    cfg = cfg or graphs.cfg
    fwd = graphs.fn
    b = graphs.builder
    names = b.param_names()
    param_nodes = [b.params[n].node for n in names]
    n_data = len(b.inputs)

    if n_micro > 1:
        data_params, loss, grads = _microbatch_grads(graphs, n_micro)
        gb = GradBuilder()  # no replacements needed (grads built inside scan)
        return _finish_step(graphs, cfg, b, names, param_nodes, data_params,
                            loss, grads, gb, b1, b2, eps)

    # -- gradients on the IR ------------------------------------------------
    loss = fwd.results[0]
    gb = GradBuilder()
    grads = gb.backprop([loss], [ops.constant(1.0, dtype=loss.dtype)],
                        [p.out() for p in param_nodes])
    grads = [g if g is not None else zeros_of(p.out_types[0])
             for g, p in zip(grads, param_nodes)]
    return _finish_step(graphs, cfg, b, names, param_nodes, list(b.inputs),
                        loss, grads, gb, b1, b2, eps)


def _finish_step(graphs, cfg, b, names, param_nodes, data_params, loss,
                 grads, gb, b1, b2, eps) -> TrainStep:
    # -- global-norm clip ---------------------------------------------------
    if cfg.grad_clip:
        sq = None
        for g in grads:
            gf = ops.convert(g, "f32")
            term = ops.reduce_sum(gf * gf)
            sq = term if sq is None else sq + term
        gnorm = ops.sqrt(sq + ops.constant(1e-12, dtype="f32"))
        clip = ops.constant(cfg.grad_clip, dtype="f32")
        scale = clip / ops.maximum(gnorm, clip)
        grads = [ops.convert(ops.convert(g, "f32") *
                             ops.broadcast_to(scale, g.shape), g.dtype)
                 for g in grads]

    # -- AdamW ---------------------------------------------------------------
    step = ops.parameter((), "i32", "step")
    step_f = ops.convert(step.out(), "f32")
    t = step_f + ops.constant(1.0, dtype="f32")
    lr_t = lr_schedule(cfg, step_f)
    c_b1 = ops.constant(b1, dtype="f32")
    c_b2 = ops.constant(b2, dtype="f32")
    one = ops.constant(1.0, dtype="f32")
    bc1 = one - ops.power(c_b1, t)
    bc2 = one - ops.power(c_b2, t)

    m_nodes: List[Node] = []
    v_nodes: List[Node] = []
    new_params: List[Value] = []
    new_m: List[Value] = []
    new_v: List[Value] = []
    for name, pn, g in zip(names, param_nodes, grads):
        spec = b.params[name]
        mp = ops.parameter(spec.shape, cfg.opt_dtype, f"m/{name}")
        vp = ops.parameter(spec.shape, cfg.opt_dtype, f"v/{name}")
        m_nodes.append(mp)
        v_nodes.append(vp)
        gf = ops.convert(g, "f32")
        mf = ops.convert(mp.out(), "f32")
        vf = ops.convert(vp.out(), "f32")
        m_new = c_b1 * mf + (one - c_b1) * gf
        v_new = c_b2 * vf + (one - c_b2) * (gf * gf)
        mhat = m_new / ops.broadcast_to(bc1, m_new.shape)
        vhat = v_new / ops.broadcast_to(bc2, v_new.shape)
        upd = mhat / (ops.sqrt(vhat) + ops.constant(eps, dtype="f32"))
        pf = ops.convert(pn.out(), "f32")
        if cfg.weight_decay and len(spec.shape) >= 2:
            upd = upd + ops.constant(cfg.weight_decay, dtype="f32") * pf
        p_new = pf - ops.broadcast_to(lr_t, upd.shape) * upd
        new_params.append(ops.convert(p_new, spec.dtype))
        new_m.append(ops.convert(m_new, cfg.opt_dtype))
        new_v.append(ops.convert(v_new, cfg.opt_dtype))

    all_params = list(data_params) + [step] + param_nodes + m_nodes + v_nodes
    results = [loss] + new_params + new_m + new_v
    fn = Function(all_params, results, name=f"{graphs.fn.name}_step")
    fn = gb.apply_replacements(fn)
    return TrainStep(fn, len(data_params), names, graphs)


def init_opt_state(builder: ModelBuilder, cfg: ModelConfig,
                   params: Dict[str, np.ndarray]):
    from ..core.types import as_dtype
    dt = as_dtype(cfg.opt_dtype)
    m = {k: np.zeros(v.shape, dt) for k, v in params.items()}
    v = {k: np.zeros(p.shape, dt) for k, p in params.items()}
    return m, v
