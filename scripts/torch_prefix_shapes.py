"""Greedy tokens of one request through the paged engine at several
graph shapes: the harness's E16 prompt (``scripts/torch_bench.py``, seed
0, 32 tokens, page 4, 8 new tokens) alone on three slots at the default
prefill chunk (16), then on one slot at prefill chunks 16, 5, 8, 32 and 0
(dense), in the main path's compute type and in f32.

    python scripts/torch_prefix_shapes.py [--device cuda|cpu] [--reduced] [--layers N]
    python scripts/torch_prefix_shapes.py --first-diff [--dtype bf16|f32] [...]

Prints one line per leg: its compute type, slots, chunk, tokens, and
``same`` or ``DIFF`` against the three-slot run of that compute type,
for the tokens and for the first decode step's logits of the request
(the row the second token is picked from), compared bit for bit.  The
paged legs (every chunk but 0) attend through one composition, so they
must agree in both compute types; the dense leg (chunk 0) attends
through the Attention op (flash at d_head 128) and is printed, not held.

``--first-diff`` runs the legs eagerly with every emitted step recorded
(:class:`Recorder`, a wrap of ``torch_emit._execute``) and names the
first node, in execution order, whose output bits differ on the
request's rows: three slots against one (both at chunk 16; an output
with a batch axis of 3 against 1 is read at the request's slot), and
chunk 16 against chunk 8 on one slot (a prefill output with a chunk axis
of 16 against 8 is read at the same positions; one without, such as a
KV page, is not compared: the decode dispatches read what it wrote).
Only floating values are compared (integers and masks are positions and
indices that follow the shapes); outputs of other shapes (the page pool,
whose page count follows the slot count) and of more than ``--snap-mb``
are not compared, and the report counts them.  On the card it runs as

    python scripts/torch_prefix_shapes.py --first-diff --dtype bf16
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import difflib
import os
import sys
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CHUNKS = (16, 5, 8, 32, 0)
SLOTS, PROMPT, NEW, PAGE, MAX_LEN = 3, 32, 8, 4, 40
SLOT = 0   # the slot a lone request takes (the pool hands out slot 0 first)
SNAP_MB = 8.0   # --first-diff keeps outputs of at most this many MB
# ops that move or convert values element by element: no sum of theirs
# can depend on a batch's shape, and they carry the trash pages' contents
MOVES = frozenset(("Gather", "Transpose", "Reshape", "BroadcastInDim",
                   "Slice", "DynamicSlice", "DynamicUpdateSlice",
                   "Concatenate", "Parameter", "Convert",
                   "ShardingConstraint"))


class Recorder:
    """Every emitted step of the programs run inside :meth:`active`:
    ``torch_emit._execute`` is wrapped so that each step's emitter is
    seen with its arguments and outputs.  Keeps the first decode step's
    logits (the input of the first ``ArgMax`` of a decode dispatch) and,
    with ``snapshots``, a host copy of every output of at most
    ``limit`` bytes, keyed by (dispatch kind, dispatch index, body, the
    step's place in the body's plan, occurrence).  Node names are made
    by a process-wide counter, so two builds of one graph share places,
    not names.  Eager runs only: a replayed CUDA graph runs no
    step."""

    def __init__(self, snapshots: bool = False,
                 limit: int = int(SNAP_MB * (1 << 20))):
        self.snapshots = snapshots
        self.limit = limit
        self.records = []            # (key, node, [host tensor or None])
        self.first_logits = None
        self.skipped_large = 0
        self._depth = 0
        self._dispatch = None        # (kind, index) of the running call
        self._seen = collections.Counter()
        self._occ = collections.Counter()
        self._prologue = 0

    @staticmethod
    def kind(fn_name: str) -> str:
        return "prefill" if "prefill" in fn_name else "decode"

    def _step(self, body, t, emit):
        def run(node, args, ctx):
            outs = emit(node, args, ctx)
            kind = self._dispatch[0]
            if node.op == "ArgMax" and kind == "decode" and \
                    self.first_logits is None:
                self.first_logits = args[0][SLOT].detach().cpu().clone()
            if self.snapshots:
                occ_key = (body, t)
                occ = self._occ[occ_key]
                self._occ[occ_key] += 1
                snaps = []
                for o in outs:
                    big = o.numel() * o.element_size() > self.limit
                    self.skipped_large += big
                    snaps.append(None if big else o.detach().cpu().clone())
                self.records.append(((*self._dispatch, body, t, occ),
                                     node, snaps))
            return outs
        return run

    @contextlib.contextmanager
    def active(self):
        from repro_torch.transformers import torch_emit as te
        orig, orig_prologue = te._execute, te.ScanBody.prologue

        def traced(plan, env, ctx, name, writes=None):
            self._depth += 1
            if self._depth == 1:   # a dispatch, not a Scan body inside one
                kind = self.kind(name)
                self._dispatch = (kind, self._seen[kind])
                self._seen[kind] += 1
                self._occ.clear()
            body = f"{name} prologue" if self._prologue else name
            try:
                wrapped = [(self._step(body, t, emit), node, ins, out0, dead)
                           for t, (emit, node, ins, out0, dead)
                           in enumerate(plan)]
                return orig(wrapped, env, ctx, name, writes)
            finally:
                self._depth -= 1

        def prologue(scan_body, consts):
            self._prologue += 1
            try:
                return orig_prologue(scan_body, consts)
            finally:
                self._prologue -= 1

        te._execute, te.ScanBody.prologue = traced, prologue
        try:
            yield self
        finally:
            te._execute, te.ScanBody.prologue = orig, orig_prologue


def e16_prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, vocab, size=(PROMPT,)).astype(np.int32)


def run_leg(tb, model, slots: int, chunk=None, *,
            recorder: Optional[Recorder] = None):
    """One request alone on ``slots`` slots at prefill ``chunk`` (None:
    the engine's default), eagerly; returns (tokens, first decode step's
    logits, the :class:`Recorder`, a fresh one unless given)."""
    kw = {} if chunk is None else {"prefill_chunk": chunk}
    eng = tb._engine(model, options=tb._options(static_jit=False),
                     mode="paged", slots=slots, max_len=MAX_LEN,
                     page_size=PAGE, chunk_steps=2, **kw)
    rec = recorder or Recorder()
    with rec.active():
        rid = eng.submit(e16_prompt(model.vocab), NEW)
        tokens = eng.run().results[rid].tolist()
    return tokens, rec.first_logits, rec


def _bits_equal(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def _align(a, b, sizes):
    """The one axis where ``a`` and ``b`` differ, with sizes ``sizes``
    (a's, b's), or None."""
    if a.ndim != b.ndim:
        return None
    diff = [i for i in range(a.ndim) if a.shape[i] != b.shape[i]]
    if len(diff) == 1 and (a.shape[diff[0]], b.shape[diff[0]]) == sizes:
        return diff[0]
    return None


class _Partner:
    """Leg b's record for a record of leg a.  Records are grouped by one
    run of one body (dispatch kind and index, body, occurrence); within a
    group the two legs' steps are matched on their op sequences
    (``difflib``), since a graph built at another shape may fold or keep
    a node the other drops."""

    def __init__(self, ra, rb):
        self.ga, self.where = self._index(ra)
        self.gb, _ = self._index(rb)
        self._maps = {}

    @staticmethod
    def _index(records):
        groups = collections.defaultdict(list)
        where = []
        for key, node, snaps in records:
            g = (key[0], key[1], key[2], key[4])
            where.append((g, len(groups[g])))
            groups[g].append((node, snaps))
        return groups, where

    def __call__(self, ga: tuple, i: int, gb: tuple):
        if gb not in self.gb:
            return None
        if (ga, gb) not in self._maps:
            sm = difflib.SequenceMatcher(
                None, [n.op for n, _ in self.ga[ga]],
                [n.op for n, _ in self.gb[gb]], autojunk=False)
            self._maps[(ga, gb)] = {i + d: j + d for i, j, size
                                    in sm.get_matching_blocks()
                                    for d in range(size)}
        j = self._maps[(ga, gb)].get(i)
        return None if j is None else self.gb[gb][j][1]


def _pairs_slots(ra, rb):
    """(key, node, a part, b part) of three slots (``ra``) against one
    (``rb``), both at one chunk: a batch axis of 3 is read at the
    request's slot."""
    partner = _Partner(ra, rb)
    for (key, node, snaps), (g, i) in zip(ra, partner.where):
        other = partner(g, i, g)
        if other is None:
            yield key, node, None, None
            continue
        for a, b in zip(snaps, other):
            if a is None or b is None:
                yield key, node, None, None
            elif a.shape == b.shape:
                yield key, node, a, b
            else:
                ax = _align(a, b, (SLOTS, 1))
                yield (key, node, None, None) if ax is None else \
                    (key, node, a.narrow(ax, SLOT, 1), b)


def _pairs_chunks(ra, rb, big: int, small: int):
    """Chunk ``big`` (``ra``) against chunk ``small`` (``rb``) on one
    slot.  Prefill dispatch d of ``ra`` covers the positions of ``rb``'s
    dispatches d*r .. d*r + r - 1 (r = big // small): an output with a
    chunk axis is read in r parts; one without (a KV page, a write mask
    of the whole chunk) is not compared, and what the prefill wrote
    shows in the decode dispatches, which share keys."""
    r = big // small
    partner = _Partner(ra, rb)
    for (key, node, snaps), (g, i) in zip(ra, partner.where):
        kind, d, body, occ = g
        if kind != "prefill":
            others = [(None, partner(g, i, g))]
        else:
            others = [(h, partner(g, i, (kind, d * r + h, body, occ)))
                      for h in range(r)]
        for j, a in enumerate(snaps):
            for h, other in others:
                b = None if other is None else other[j]
                if a is None or b is None:
                    yield key, node, None, None
                    continue
                ax = _align(a, b, (big, small))
                if ax is not None:
                    yield key, node, a.narrow(ax, h * small, small), b
                elif a.shape == b.shape and h is None:
                    yield key, node, a, b
                elif h in (None, 0):
                    yield key, node, None, None


def _care_masks(pairs) -> dict:
    """``{(key, part): mask}``: the elements of an output that a later
    ``Select`` keeps.  Attention's scores past a request's position read
    unwritten or shared trash pages, whose contents follow the slot count
    and the chunk by design; the mask drops them before the softmax, so
    the scores (and their scaling) are compared where the mask keeps
    them.  A node's latest record is the one a later node read (a mask
    hoisted out of a Scan's steps is recorded once, in its prologue)."""
    parts = collections.defaultdict(list)
    for key, _node, a, b in pairs:
        parts[key].append((a, b))
    recent, care = {}, {}
    for key, node, _a, _b in pairs:
        recent[id(node)] = key
        if node.op != "Select":
            continue
        shape = tuple(node.out_types[0].shape)
        preds = parts.get(recent.get(id(node.inputs[0].node)), [])
        x = node.inputs[1].node
        while tuple(x.out_types[0].shape) == shape and id(x) in recent:
            for j, (pa, pb) in enumerate(preds):
                if pa is not None and pa.dtype == torch.bool:
                    care[(recent[id(x)], j)] = pa & pb
            if x.op not in ("Multiply", "Convert"):
                break
            x = x.inputs[0].node
    return care


def first_diff(pairs, label: str, show: int = 5) -> dict:
    """Walk (key, node, a, b) in execution order; print the first
    ``show`` nodes whose compared parts differ bit for bit (where a later
    ``Select`` keeps them, :func:`_care_masks`)."""
    pairs = list(pairs)
    care = _care_masks(pairs)
    compared = skipped = 0
    found = []
    part = collections.Counter()
    for key, node, a, b in pairs:
        j = part[key]
        part[key] += 1
        # integer and boolean values are positions, indices and masks,
        # which follow the graph's shape by design
        if a is None or not a.is_floating_point() or node.op in MOVES:
            skipped += 1
            continue
        compared += 1
        keep = care.get((key, j))
        if keep is not None:
            a, b = a[keep], b[keep]
        if not _bits_equal(a, b) and len(found) < show:
            d = float((a.double() - b.double()).abs().max())
            ins = ",".join(f"{v.node.op}{tuple(v.type.shape)}:"
                           f"{v.type.dtype}" for v in node.inputs)
            found.append(dict(key=key, op=node.op, name=node.name,
                              shape=tuple(node.out_types[0].shape),
                              dtype=str(a.dtype), max_abs_diff=d,
                              masked=keep is not None, inputs=ins))
    for i, f in enumerate(found):
        kind, disp, body, t, occ = f["key"]
        print(f"[first-diff] {label} #{i + 1}: {f['op']} {f['name']!r} "
              f"(step {t}) in {body} ({kind} dispatch {disp}, occurrence "
              f"{occ}) out {f['shape']} {f['dtype']} max|diff| "
              f"{f['max_abs_diff']:.3e}"
              f"{' where the mask keeps' if f['masked'] else ''} inputs "
              f"{f['inputs']}", flush=True)
    print(f"[first-diff] {label}: {'no difference' if not found else 'DIFF'}"
          f" compared={compared} not_compared={skipped}", flush=True)
    return {"label": label, "compared": compared, "not_compared": skipped,
            "diffs": found}


def run_first_diff(tb, model, snap_mb: float = SNAP_MB) -> list:
    """Three slots against one at chunk 16, and chunk 16 against chunk 8
    on one slot, each pair's first differing node (:func:`first_diff`);
    outputs over ``snap_mb`` MB are not kept."""
    def leg(slots, chunk):
        return run_leg(tb, model, slots, chunk, recorder=Recorder(
            True, int(snap_mb * (1 << 20))))

    three = leg(SLOTS, 16)
    one = leg(1, 16)
    out = [first_diff(_pairs_slots(three[2].records, one[2].records),
                      f"{model.compute_dtype} slots 3 vs 1 (chunk 16)")]
    del three
    eight = leg(1, 8)
    out.append(first_diff(_pairs_chunks(one[2].records, eight[2].records,
                                        16, 8),
                          f"{model.compute_dtype} chunk 16 vs 8 (1 slot)"))
    for name, leg in (("slots=3", None), ("chunk=16", one),
                      ("chunk=8", eight)):
        if leg is not None:
            print(f"[first-diff] {model.compute_dtype} {name} tokens "
                  f"{leg[0]} large_outputs_not_kept "
                  f"{leg[2].skipped_large}", flush=True)
    return out


def run_legs(tb, model, chunks=CHUNKS) -> list:
    """The three-slot run and the one-slot chunk legs of one compute
    type: ``[(slots, chunk, tokens, logits, same_tokens, same_logits)]``
    against the three-slot run, one line each."""
    ref_tokens, ref_logits, _ = run_leg(tb, model, SLOTS)
    out = [(SLOTS, None, ref_tokens, ref_logits, True, True)]
    print(f"{model.compute_dtype} slots={SLOTS} chunk=default {ref_tokens}",
          flush=True)
    for chunk in chunks:
        tokens, logits, _ = run_leg(tb, model, 1, chunk)
        same_t = tokens == ref_tokens
        same_l = _bits_equal(logits, ref_logits)
        out.append((1, chunk, tokens, logits, same_t, same_l))
        print(f"{model.compute_dtype} slots=1 chunk={chunk} {tokens} "
              f"tokens {'same' if same_t else 'DIFF'} first_step_logits "
              f"{'same' if same_l else 'DIFF'}"
              + (" (dense prefill: another form, not held)"
                 if chunk == 0 else ""), flush=True)
    return out


def main(argv=None) -> int:
    import torch_bench as tb

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--first-diff", action="store_true",
                    help="name the first node whose bits differ between "
                         "legs (eager, every step recorded)")
    ap.add_argument("--dtype", choices=("bf16", "f32", "both"),
                    default="both", help="compute types to run")
    ap.add_argument("--snap-mb", type=float, default=SNAP_MB,
                    help="--first-diff: outputs larger than this many "
                         "MB are not kept")
    args = ap.parse_args(argv)
    tb.configure(args.device, args.reduced, args.layers)
    cfg = tb._cfg()
    models = {"bf16": [cfg], "f32": [tb._f32(cfg)],
              "both": [cfg, tb._f32(cfg)]}[args.dtype]
    bad = 0
    for model in models:
        if args.first_diff:
            run_first_diff(tb, model, args.snap_mb)
        else:
            legs = run_legs(tb, model)
            bad += sum(not (t and lg) for _s, c, _t, _l, t, lg in legs
                       if c != 0)
        tb.free()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
