"""End-to-end training driver on torch (the port of
``repro/launch/train.py``).

Wires every layer of the stack together: config -> IR graphs (bridge) ->
IR autodiff + AdamW (train_graph) -> the torch backend (the Hopper
kernels at O2 with ``--kernels``; each step captured as a CUDA graph on
the card) -> data pipeline -> checkpoint/restore -> fault-tolerance
hooks.  The gradient is IR autodiff: torch autograd plays no part.

The step is compiled with its parameters and AdamW moments donated and
called through ``.raw``: on the card the state stays in the same device
tensors, which every step overwrites in place; the loss is read with
``.item()`` and checkpoints copy the state to host numpy, on this
thread, before the next step runs.  The multimodal families take the
reference's stubbed inputs beside the batch: whisper's frames and vlm's
images, drawn from ``default_rng([seed, step])``.

Usage (on the card; ``--device cpu`` runs on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --reduced --steps 200 --batch 8 --seq 64 --level O2 --kernels
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np


def step_data(cfg, builder, batch, seed: int, step: int,
              n: int) -> list:
    """A train step's data arguments in the graph's input order, as the
    reference's trainer passes them: the batch's tokens and labels, after
    whisper's stubbed frames or before vlm's stubbed images, each drawn
    from ``default_rng([seed, step])`` in f32 at 0.02 for ``n`` rows."""
    names = {node.name for node in builder.inputs}
    dargs = [batch["tokens"], batch["labels"]]
    if "frames" in names:
        rng = np.random.default_rng([seed, step])
        dargs = [rng.normal(size=(n, cfg.enc_seq, cfg.d_model))
                 .astype(np.float32) * 0.02] + dargs
    if "images" in names:
        rng = np.random.default_rng([seed, step])
        dargs = dargs + [
            (rng.normal(size=(n, cfg.vision_tokens,
                              cfg.vision_dim)) * 0.02).astype(np.float32)]
    return dargs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke-scale) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--n-micro", type=int, default=1,
                    help="gradient-accumulation microbatches")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu' (default: the card)")
    ap.add_argument("--level", default="O1", choices=("O0", "O1", "O2"),
                    help="pass-pipeline level")
    ap.add_argument("--kernels", action="store_true",
                    help="run the fused compounds through the Hopper "
                         "kernels (use_pallas=True)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent compile-cache dir (default: "
                         "$REPRO_CACHE_DIR if set, else disabled) — a "
                         "restarted run skips the pass pipeline for the "
                         "unchanged train-step graph")
    ap.add_argument("--autotune", action="store_true",
                    help="resolve attention knobs via the recorded sweep")
    args = ap.parse_args(argv)

    from ..backend import Backend, CompileOptions
    from ..configs import get_config
    from ..configs.base import ShapeConfig
    from ..devices import as_tensor, to_numpy
    from ..models.lm import build_graphs
    from ..models.train_graph import init_opt_state, make_train_step
    from ..runtime.checkpoint import AsyncCheckpointer, CheckpointManager
    from ..runtime.data import DataConfig, Prefetcher, SyntheticLM
    from ..runtime.fault import Heartbeat, StragglerDetector, retry_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mb = args.batch // args.n_micro
    shape = ShapeConfig("train", "train", args.seq, mb)
    graphs = build_graphs(cfg, shape, mb)
    ts = make_train_step(graphs, cfg, n_micro=args.n_micro)
    b = graphs.builder
    names = ts.param_names

    n_data = len(b.inputs)
    n_p = len(names)
    donate = tuple(range(n_data + 1, n_data + 1 + 3 * n_p))
    be = Backend.create("torch", device=args.device)
    dev = be.device
    compiled = be.compile(
        ts.fn, CompileOptions(level=args.level, use_pallas=args.kernels,
                              donate_argnums=donate,
                              cache_dir=args.cache_dir,
                              autotune=args.autotune))
    step_fn = compiled.raw  # torch-native callable: donation honored
    st = be.cache_stats()
    if st.disk_hits or st.disk_misses:
        print(f"[compile-cache] disk_hits={st.disk_hits} "
              f"disk_misses={st.disk_misses} "
              f"pipeline {'skipped (warm start)' if compiled.from_disk else 'ran'}")

    # -- state: fresh or restored ------------------------------------------------
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    ckpt = AsyncCheckpointer(mgr)
    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        start_step, tensors, extra = mgr.restore()
        params = {n: tensors[f"p/{n}"] for n in names}
        m = {n: tensors[f"m/{n}"] for n in names}
        v = {n: tensors[f"v/{n}"] for n in names}
        print(f"[restore] step {start_step} from {args.ckpt_dir}")
    else:
        params = b.init_params(args.seed)
        m, v = init_opt_state(b, cfg, params)

    flat = [params[n] for n in names] + [m[n] for n in names] + \
        [v[n] for n in names]
    flat = [as_tensor(x, dev) for x in flat]

    # -- data ----------------------------------------------------------------------
    data = SyntheticLM(DataConfig(cfg.vocab, args.seq, args.batch,
                                  seed=args.seed))
    prefetch = Prefetcher(data, start_step=start_step)
    hb = Heartbeat(os.path.join(args.ckpt_dir, "heartbeat.json"))
    straggler = StragglerDetector()

    losses: List[float] = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        got_step, batch = prefetch.next()
        assert got_step == step, (got_step, step)
        dargs = step_data(cfg, b, batch, args.seed, step, args.batch)

        def one_step():
            t0 = time.time()
            outs = step_fn(*dargs, np.int32(step), *flat)
            loss = float(outs[0].item())
            return loss, list(outs[1:]), time.time() - t0

        loss, flat, dt = retry_step(one_step)
        losses.append(loss)
        hb.beat(step, loss=loss)
        if straggler.record(step, dt):
            print(f"[straggler] step {step}: {dt:.2f}s")
        if args.log_every and step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            tensors: Dict[str, np.ndarray] = {}
            for i, n in enumerate(names):
                tensors[f"p/{n}"] = to_numpy(flat[i])
                tensors[f"m/{n}"] = to_numpy(flat[n_p + i])
                tensors[f"v/{n}"] = to_numpy(flat[2 * n_p + i])
            ckpt.save(step + 1, tensors, extra={"arch": args.arch})

    ckpt.wait()
    prefetch.close()
    dt = time.time() - t_start
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"[done] {len(losses)} steps on {dev} in {dt:.1f}s; "
          f"loss {first:.4f} -> {last:.4f}")
    return 0 if (not losses or last <= first + 1e-3) else 1


if __name__ == "__main__":
    raise SystemExit(main())
