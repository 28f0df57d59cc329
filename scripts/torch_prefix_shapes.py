"""Greedy tokens of one request through the paged engine at several
graph shapes: the harness's E16 prompt (``scripts/torch_bench.py``, seed
0, 32 tokens, page 4, 8 new tokens) alone on three slots at the default
prefill chunk, then on one slot at prefill chunks 16, 5, 8, 32 and 0
(dense), in the main path's compute type and in f32.

    python scripts/torch_prefix_shapes.py [--device cuda|cpu] [--reduced] [--layers N]

Prints one line per leg: its compute type, slots, chunk, tokens, and
``same`` or ``DIFF`` against the three-slot run of that compute type.
It shows which shapes change a greedy token, the split E16's
``prefix_chunked_prefill_parity_bf16`` row records.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CHUNKS = (16, 5, 8, 32, 0)


def main(argv=None) -> int:
    import torch_bench as tb

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    tb.configure(args.device, args.reduced, args.layers)
    cfg = tb._cfg()
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(32,)).astype(np.int32)

    def tokens(model, slots, **kw):
        eng = tb._engine(model, mode="paged", slots=slots, max_len=40,
                         page_size=4, chunk_steps=2, **kw)
        rid = eng.submit(prompt, 8)
        return eng.run().results[rid].tolist()

    for model in (cfg, tb._f32(cfg)):
        ref = tokens(model, 3)
        print(f"{model.compute_dtype} slots=3 chunk=default {ref}",
              flush=True)
        for chunk in CHUNKS:
            got = tokens(model, 1, prefill_chunk=chunk)
            print(f"{model.compute_dtype} slots=1 chunk={chunk} {got} "
                  f"{'same' if got == ref else 'DIFF'}", flush=True)
        tb.free()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
