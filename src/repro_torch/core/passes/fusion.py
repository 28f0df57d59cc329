"""Pattern-matched compounding of operations (paper sec. 1/4:
"HW-specific compounding of operations", MKL-DNN-style fused kernels).

Detects decomposed primitive subgraphs and replaces them with compound ops
(Silu, Gelu, Softmax, RMSNorm, Attention) that the backend transformer can
map to fused kernels (Pallas on TPU).  The inverse of ``Decompose``;
``tests/test_passes.py`` round-trips decompose -> fuse.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .. import ops
from ..function import Function, transform
from ..node import Node, Value
from ..pattern import (Pat, any_, const_, is_scalar_const, match, op_,
                       scalar_of, skip_, skip_reshape)
from .base import Pass


def _bcast_of(p: Pat) -> Pat:
    return op_("BroadcastInDim", skip_(("Reshape",), p))


# silu: Multiply(x, Sigmoid(x))
_SILU = op_("Multiply", any_("x"), op_("Sigmoid", any_("x")), commutative=True)

# gelu: Multiply(Multiply(bcast(0.5), x), Add(bcast(1), Erf(Multiply(x, bcast(1/sqrt2)))))
_GELU = op_(
    "Multiply",
    op_("Multiply", _bcast_of(const_(0.5)), any_("x"), commutative=True),
    op_("Add", _bcast_of(const_(1.0)),
        op_("Erf", op_("Multiply", any_("x"), _bcast_of(const_(1.0 / math.sqrt(2.0), tol=1e-6)),
                       commutative=True)),
        commutative=True),
    commutative=True,
)

# softmax: Divide(e, bcast(ReduceSum(e))) where e = Exp(Sub(x, bcast(ReduceMax(x))))
_EXP = op_("Exp", op_("Subtract", any_("x"),
                      _bcast_of(op_("ReduceMax", any_("x"), capture="rmax"))),
           capture="e")
_SOFTMAX = op_("Divide", _EXP, _bcast_of(op_("ReduceSum", Pat(capture="e"),
                                             capture="rsum")))


def _axes_of(v: Value):
    return v.node.attrs["axes"]


class FuseCompounds(Pass):
    """``enable`` gates the *matmul-level* compounds individually (keys
    ``swiglu`` / ``norm_matmul`` / ``rotary_qkv``, missing = on) so the
    autotuner can flip each fusion per graph; the pointwise/softmax/
    attention compounds are always on (they never lose)."""

    name = "fuse-compounds"

    def __init__(self, enable: Optional[dict] = None):
        enable = enable or {}
        self.fuse_swiglu = bool(enable.get("swiglu", True))
        self.fuse_norm_matmul = bool(enable.get("norm_matmul", True))
        self.fuse_rotary_qkv = bool(enable.get("rotary_qkv", True))

    def run(self, fn: Function):
        stats = {"silu": 0, "gelu": 0, "softmax": 0, "rmsnorm": 0,
                 "attention": 0, "swiglu": 0, "norm_matmul": 0,
                 "rotary_qkv": 0}
        return self._run_on(fn, stats), stats

    def _run_on(self, fn: Function, stats: dict) -> Function:
        def base_rule(node: Node, ins: List[Value]) -> Optional[List[Value]]:
            cand = Node(node.op, ins, dict(node.attrs), node.out_types)
            v = cand.out(0) if cand.n_outputs else None
            if v is None:
                return None
            m = match(_SILU, v)
            if m is not None:
                stats["silu"] += 1
                return [ops.silu(m["x"])]
            m = match(_GELU, v)
            if m is not None:
                stats["gelu"] += 1
                return [ops.gelu(m["x"])]
            m = match(_SOFTMAX, v)
            if m is not None:
                ax_max = _axes_of(m["rmax"])
                ax_sum = _axes_of(m["rsum"])
                if ax_max == ax_sum and len(ax_max) == 1 and \
                        m["rmax"].node.attrs["keepdims"] and \
                        m["rsum"].node.attrs["keepdims"]:
                    stats["softmax"] += 1
                    return [ops.softmax(m["x"], axis=ax_max[0])]
            out = self._match_rmsnorm(v)
            if out is not None:
                stats["rmsnorm"] += 1
                return [out]
            out = self._match_attention(v)
            if out is not None:
                stats["attention"] += 1
                return [out]
            return None

        def mm_rule(node: Node, ins: List[Value]) -> Optional[List[Value]]:
            # matmul-level compounds: need the base compounds (Silu,
            # Attention) already restored, hence a separate round
            cand = Node(node.op, ins, dict(node.attrs), node.out_types)
            v = cand.out(0) if cand.n_outputs else None
            if v is None:
                return None
            if self.fuse_swiglu:
                out = self._match_swiglu(v)
                if out is not None:
                    stats["swiglu"] += 1
                    return [out]
            if self.fuse_rotary_qkv:
                out = self._match_rotary_attention(v)
                if out is not None:
                    stats["rotary_qkv"] += 1
                    return [out]
            return None

        def nm_rule(node: Node, ins: List[Value]) -> Optional[List[Value]]:
            # NormMatmul last: it must not steal the gate/up/qkv matmuls
            # that SwiGLU / RotaryQKV root their own patterns on
            cand = Node(node.op, ins, dict(node.attrs), node.out_types)
            v = cand.out(0) if cand.n_outputs else None
            if v is None:
                return None
            out = self._match_norm_matmul(v)
            if out is not None:
                stats["norm_matmul"] += 1
                return [out]
            return None

        def body_rule(node: Node, ins: List[Value]) -> Optional[List[Value]]:
            # recurse into Function-valued attrs (Scan bodies): the dense
            # models keep their per-layer blocks inside scan bodies, and
            # that is where the serve/train hot-path compounds live
            sub_fns = {k: f for k, f in node.attrs.items()
                       if isinstance(f, Function)}
            if not sub_fns:
                return None
            attrs = dict(node.attrs)
            for k, sub in sub_fns.items():
                attrs[k] = self._run_on(sub, stats)
            n = Node(node.op, ins, attrs, node.out_types)
            return [n.out(i) for i in range(n.n_outputs)]

        # two rounds: attention matches Softmax nodes produced in round 1
        out_fn = transform(fn, base_rule, name=fn.name)
        out_fn = transform(out_fn, base_rule, name=fn.name)
        if self.fuse_swiglu or self.fuse_rotary_qkv:
            out_fn = transform(out_fn, mm_rule, name=fn.name)
        if self.fuse_norm_matmul:
            out_fn = transform(out_fn, nm_rule, name=fn.name)
        out_fn = transform(out_fn, body_rule, name=fn.name)
        return out_fn

    # -- shared helpers ----------------------------------------------------
    @staticmethod
    def _unwrap(v: Value, through=("ShardingConstraint",)) -> Value:
        while v.node.op in through and len(v.node.inputs) == 1:
            v = v.node.inputs[0]
        return v

    @staticmethod
    def _is_matmul2(n: Node) -> bool:
        """DotGeneral emitted by ``ops.matmul`` with a rank-2 rhs."""
        return (n.op == "DotGeneral" and n.attrs["batch"] == ((), ())
                and n.inputs[1].rank == 2
                and n.attrs["contracting"] == ((n.inputs[0].rank - 1,), (0,)))

    # -- swiglu: DotGeneral(Multiply(Silu(DG(x, wg)), DG(x, wu)), wd) ------
    def _match_swiglu(self, v: Value) -> Optional[Value]:
        node = v.node
        if not (node.op == "DotGeneral" and self._is_matmul2(node)):
            return None
        h = self._unwrap(node.inputs[0])
        if h.node.op != "Multiply":
            return None
        a, b = h.node.inputs
        for gate, up in ((a, b), (b, a)):
            g = self._unwrap(gate)
            if g.node.op != "Silu":
                continue
            gm = self._unwrap(g.node.inputs[0])
            um = self._unwrap(up)
            if not (self._is_matmul2(gm.node) and self._is_matmul2(um.node)):
                continue
            x1, wg = gm.node.inputs
            x2, wu = um.node.inputs
            if x1 != x2:
                continue
            try:
                fused = ops.swiglu(x1, wg, wu, node.inputs[1])
            except ValueError:
                continue
            if fused.shape != v.shape:
                continue
            if fused.dtype != v.dtype:
                fused = ops.convert(fused, v.dtype)
            return fused
        return None

    # -- norm+matmul: DotGeneral(RMSNorm(x, g), w) -------------------------
    def _match_norm_matmul(self, v: Value) -> Optional[Value]:
        node = v.node
        if not (node.op == "DotGeneral" and self._is_matmul2(node)):
            return None
        nrm = self._unwrap(node.inputs[0])
        if nrm.node.op != "RMSNorm":
            return None
        x, g = nrm.node.inputs
        try:
            fused = ops.norm_matmul(x, g, node.inputs[1],
                                    eps=nrm.node.attrs["eps"])
        except ValueError:
            return None
        if fused.shape != v.shape:
            return None
        if fused.dtype != v.dtype:
            fused = ops.convert(fused, v.dtype)
        return fused

    # -- rotary+qkv: Attention(rope(proj q), rope(proj k), proj v) ---------
    def _match_rotary_attention(self, v: Value) -> Optional[Value]:
        node = v.node
        if node.op != "Attention":
            return None
        q, k, vv = node.inputs[:3]
        rq = self._match_rope_proj(q)
        rk = self._match_rope_proj(k)
        pv = self._match_plain_proj(vv)
        if rq is None or rk is None or pv is None:
            return None
        xq, wq, cq, sq, n_heads = rq
        xk, wk, ck, sk, n_kv = rk
        xv, wv, hv = pv
        if not (xq == xk and xq == xv) or cq != ck or sq != sk or hv != n_kv:
            return None
        try:
            q2, k2, v2 = ops.rotary_qkv(xq, wq, wk, wv, cq, sq,
                                        n_heads=n_heads, n_kv=n_kv)
        except ValueError:
            return None
        for new, old in ((q2, q), (k2, k), (v2, vv)):
            if new.shape != old.shape or new.dtype != old.dtype:
                return None
        q_offset = node.inputs[3] if node.attrs["has_offset"] else None
        out = ops.attention(q2, k2, v2, causal=node.attrs["causal"],
                            window=node.attrs["window"],
                            scale=node.attrs["scale"], q_offset=q_offset)
        return out

    def _match_plain_proj(self, v: Value):
        """constrain(split_heads(matmul(x, w), H)) -> (x, w, H)."""
        t = self._unwrap(v)
        if t.node.op != "Transpose" or t.node.attrs["perm"] != (0, 2, 1, 3):
            return None
        r = t.node.inputs[0]
        if r.node.op != "Reshape" or r.rank != 4:
            return None
        mm = self._unwrap(r.node.inputs[0])
        if mm.rank != 3 or not self._is_matmul2(mm.node):
            return None
        x, w = mm.node.inputs
        B, S, H, d = r.shape
        if mm.shape != (B, S, H * d):
            return None
        return x, w, H

    def _match_rope_proj(self, v: Value):
        """``components.apply_rope`` over a plain head projection:
        Concat([x1*c - x2*s, x2*c + x1*s], -1) with x1/x2 the half-slices
        of split_heads(matmul(x, w)) -> (x, w, cos, sin, H)."""
        n = v.node
        if n.op != "Concat" or len(n.inputs) != 2 or v.rank != 4 or \
                n.attrs["axis"] != 3:
            return None
        lo, hi = n.inputs
        if lo.node.op != "Subtract" or hi.node.op != "Add":
            return None
        m1, m2 = lo.node.inputs
        m3, m4 = hi.node.inputs
        if any(m.node.op != "Multiply" for m in (m1, m2, m3, m4)):
            return None
        x1, c1 = m1.node.inputs
        x2, s1 = m2.node.inputs
        x2b, c2 = m3.node.inputs
        x1b, s2 = m4.node.inputs
        if x1 != x1b or x2 != x2b or c1 != c2 or s1 != s2:
            return None
        cos = self._rope_table_of(c1)
        sin = self._rope_table_of(s1)
        if cos is None or sin is None:
            return None
        if x1.node.op != "Slice" or x2.node.op != "Slice":
            return None
        qh = x1.node.inputs[0]
        if x2.node.inputs[0] != qh or qh.rank != 4:
            return None
        B, H, S, D = qh.shape
        half = D // 2
        if D % 2 or cos.shape != (S, half) or sin.shape != (S, half):
            return None
        ones = (1,) * 4
        if x1.node.attrs["strides"] != ones or \
                x2.node.attrs["strides"] != ones:
            return None
        if x1.node.attrs["starts"] != (0, 0, 0, 0) or \
                x1.node.attrs["stops"] != (B, H, S, half):
            return None
        if x2.node.attrs["starts"] != (0, 0, 0, half) or \
                x2.node.attrs["stops"] != (B, H, S, D):
            return None
        proj = self._match_plain_proj(qh)
        if proj is None or proj[2] != H:
            return None
        return proj[0], proj[1], cos, sin, H

    @staticmethod
    def _rope_table_of(c: Value) -> Optional[Value]:
        """Convert?(BroadcastInDim(Reshape(table))) -> the (S, half) table."""
        if c.node.op == "Convert":
            c = c.node.inputs[0]
        if c.node.op != "BroadcastInDim":
            return None
        t = skip_reshape(c.node.inputs[0])
        return t if t.rank == 2 else None

    # -- rmsnorm (matches Decompose's expansion) ---------------------------
    def _match_rmsnorm(self, v: Value) -> Optional[Value]:
        # Convert(Multiply(Multiply(xf, bcast(r)), bcast(wf)))  [maybe no Convert]
        node = v.node
        if node.op == "Convert":
            inner = node.inputs[0]
        else:
            inner = v
        if inner.node.op != "Multiply":
            return None
        lhs, rhs = inner.node.inputs
        # rhs: BroadcastInDim(Convert(w)) or BroadcastInDim(w)
        if rhs.node.op != "BroadcastInDim":
            return None
        w = skip_reshape(rhs.node.inputs[0])
        if w.node.op == "Convert":
            w = w.node.inputs[0]
        if w.rank != 1:
            return None
        if lhs.node.op != "Multiply":
            return None
        xf, rb = lhs.node.inputs
        if rb.node.op != "BroadcastInDim":
            xf, rb = rb, xf
        if rb.node.op != "BroadcastInDim":
            return None
        r = skip_reshape(rb.node.inputs[0])
        if r.node.op != "Rsqrt":
            return None
        add = r.node.inputs[0]
        if add.node.op != "Add":
            return None
        var, eps_v = add.node.inputs
        if not is_scalar_const(eps_v) and not (
                eps_v.node.op == "BroadcastInDim" and is_scalar_const(eps_v.node.inputs[0])):
            var, eps_v = eps_v, var
        if eps_v.node.op == "BroadcastInDim":
            eps_v = eps_v.node.inputs[0]
        if not is_scalar_const(eps_v):
            return None
        # var = Multiply(ReduceSum(x*x, keepdims), 1/n) (reduce_mean builder)
        if var.node.op != "Multiply":
            return None
        rs, inv_n = var.node.inputs
        if rs.node.op != "ReduceSum":
            rs, inv_n = inv_n, rs
        if rs.node.op != "ReduceSum" or not rs.node.attrs["keepdims"]:
            return None
        if rs.node.attrs["axes"] != (xf.rank - 1,):
            return None
        sq = rs.node.inputs[0]
        if sq.node.op != "Multiply" or sq.node.inputs[0] != sq.node.inputs[1]:
            return None
        if sq.node.inputs[0] != xf:
            return None
        x = xf
        if x.node.op == "Convert":
            x = x.node.inputs[0]
        if w.shape != (x.shape[-1],):
            return None
        eps = scalar_of(eps_v)
        fused = ops.rms_norm(x, w, eps=eps)
        if fused.dtype != v.dtype:
            fused = ops.convert(fused, v.dtype)
        if fused.shape != v.shape:
            return None
        return fused

    # -- attention (matches Decompose's expansion, after softmax fusion) ----
    def _match_attention(self, v: Value) -> Optional[Value]:
        node = v.node
        if node.op != "DotGeneral":
            return None
        if node.attrs["contracting"] != ((4,), (2,)) or \
                node.attrs["batch"] != ((0, 1), (0, 1)):
            return None
        p, vf = node.inputs
        if p.node.op != "Softmax" or p.node.attrs["axis"] != 4:
            return None
        sel = p.node.inputs[0]
        causal = False
        window = None
        q_offset = None
        if sel.node.op == "Select":
            maskb, scores, negb = sel.node.inputs
            if negb.node.op != "BroadcastInDim" or \
                    not is_scalar_const(negb.node.inputs[0]):
                return None
            mask_flags = self._mask_flags(maskb)
            if mask_flags is None:
                return None
            causal, window, q_offset = mask_flags
        else:
            scores = sel
        if scores.node.op != "Multiply":
            return None
        dqk, scaleb = scores.node.inputs
        if dqk.node.op != "DotGeneral":
            dqk, scaleb = scaleb, dqk
        if dqk.node.op != "DotGeneral":
            return None
        if scaleb.node.op != "BroadcastInDim" or not is_scalar_const(scaleb.node.inputs[0]):
            return None
        scale = scalar_of(scaleb.node.inputs[0])
        if dqk.node.attrs["contracting"] != ((4,), (3,)) or \
                dqk.node.attrs["batch"] != ((0, 1), (0, 1)):
            return None
        q5, kf = dqk.node.inputs
        if q5.node.op != "Reshape":
            return None
        qf = q5.node.inputs[0]
        q = qf.node.inputs[0] if qf.node.op == "Convert" else qf
        k = kf.node.inputs[0] if kf.node.op == "Convert" else kf
        vv = vf.node.inputs[0] if vf.node.op == "Convert" else vf
        if q.rank != 4 or k.rank != 4 or vv.rank != 4:
            return None
        B, Hq, Sq, D = q.shape
        if k.shape[1] == 0 or Hq % k.shape[1]:
            return None
        att = ops.attention(q, k, vv, causal=causal, window=window, scale=scale,
                            q_offset=q_offset)
        out = ops.reshape(ops.convert(att, "f32"), v.shape)
        return out

    def _mask_flags(self, maskb: Value):
        """Recover (causal, window, q_offset) from the mask subgraph."""
        if maskb.node.op != "BroadcastInDim":
            return None
        m = skip_reshape(maskb.node.inputs[0])
        causal, window, q_offset = False, None, None

        def walk(val: Value) -> bool:
            nonlocal causal, window, q_offset
            n = val.node
            if n.op == "And":
                return walk(n.inputs[0]) and walk(n.inputs[1])
            if n.op == "BroadcastInDim" and n.inputs[0].node.op == "Constant":
                return bool(np.all(n.inputs[0].node.attrs["value"]))
            if n.op == "LessEqual":
                kpos, qpos = n.inputs
                if kpos.node.op == "Iota" and kpos.node.attrs["dim"] == 1:
                    ok, q_offset_v = self._offset_of(qpos)
                    if not ok:
                        # qpos is not query-iota-based (e.g. the per-row
                        # position masks of the continuous/paged serve
                        # graphs) — NOT plain causal masking
                        return False
                    causal = True
                    if q_offset_v is not None:
                        q_offset = q_offset_v
                    return True
                return False
            if n.op == "Greater":
                kpos, rhs = n.inputs
                if kpos.node.op != "Iota" or kpos.node.attrs["dim"] != 1:
                    return False
                if rhs.node.op != "Subtract":
                    return False
                qpos, wb = rhs.node.inputs
                ok, q_offset_v = self._offset_of(qpos)
                if not ok:
                    return False
                if q_offset_v is not None:
                    q_offset = q_offset_v
                if is_scalar_const(wb):
                    window_val = scalar_of(wb)
                elif wb.node.op == "BroadcastInDim" and is_scalar_const(wb.node.inputs[0]):
                    window_val = scalar_of(wb.node.inputs[0])
                else:
                    return False
                window = int(window_val)
                return True
            return False

        if not walk(m):
            return None
        return causal, window, q_offset

    @staticmethod
    def _offset_of(qpos: Value):
        """Recognize the decompose emission's query positions: Iota(dim=0)
        (no offset) or Add(Iota(dim=0), bcast(reshape(off))).  Returns
        ``(ok, offset)`` — ``(False, None)`` means qpos is something else
        entirely (a per-row position vector, say) and the mask must NOT be
        treated as plain causal."""
        n = qpos.node
        if n.op == "Iota" and n.attrs["dim"] == 0:
            return True, None
        if n.op == "Add":
            a, b = n.inputs
            if a.node.op != "Iota":
                a, b = b, a
            if a.node.op != "Iota" or a.node.attrs["dim"] != 0:
                return False, None
            off = b
            while off.node.op in ("BroadcastInDim", "Reshape"):
                off = off.node.inputs[0]
            if off.rank != 0:
                return False, None
            return True, off
        return False, None
