"""Training on torch: the port's train step (IR autodiff + AdamW,
``repro_torch.models.train_graph``) against the JAX package's, and the
port's trainer (``repro_torch.launch.train``) end to end on the CPU.

- Five steps of reduced deepseek-7b on the torch backend, at O1 and at O2
  with the kernels (their plain versions on the CPU), against the JAX
  backend's step on the same seeded numpy weights and batches: every
  step's loss and the final parameters within 1e-4 of scale with f32
  compute and 3e-2 with bf16 compute
  (``scripts/check_kernel_parity.py:69``), each AdamW moment within the
  same tolerance of its own scale, and each parameter's update over the
  five steps held against the JAX update (:func:`_update_within`); at O2
  the fusion counts meet ``EXPECTED["train"]`` of
  ``scripts/check_kernel_parity.py``.
- Microbatching against the full batch, and the LR schedules, as in
  ``tests/test_train_features.py`` (its shard_map case is in
  ``tests/test_torch_partition.py``).
- The CLI: ``--device cpu --reduced --steps 20`` exits 0 with a falling
  loss; a restarted run takes the step from the disk cache; a resumed
  run ends on the same state bit for bit; and a checkpoint written by
  either package's trainer is resumed by the other: the updates and
  moments of steps 5-8 agree as above.
"""
import dataclasses
import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import Backend as JBackend  # noqa: E402
from repro.backend import CompileOptions as JOptions  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402
from repro.launch import train as j_train_cli  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import train_graph as j_tg  # noqa: E402

from repro_torch.backend import Backend, CompileOptions  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.function import Function  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import train_graph as tg  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.data import DataConfig, SyntheticLM  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"f32": 1e-4, "bf16": 3e-2}
# an update's error in L2 over its own norm.  AdamW scales each gradient
# element to about +-lr, so an element whose bf16 gradient rounding
# crosses zero flips its whole update: bf16 is held at 0.25 (0.107 seen,
# on the embedding table), f32 at its tolerance (1.4e-5 seen)
UPDATE_L2 = {"f32": 1e-4, "bf16": 0.25}
B, S, STEPS = 2, 16, 5
TB = Backend.create("torch", device="cpu")
JT = JBackend.create("jax")


def _expected_train():
    spec = importlib.util.spec_from_file_location(
        "check_kernel_parity",
        os.path.join(ROOT, "scripts", "check_kernel_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.EXPECTED["train"]


def _within(ref, got, tol, where):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, where
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, f"{where}: {err:.3e} > {tol} x {scale:.3e}"


def _rel_l2(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    norm = float(np.linalg.norm(ref))
    assert norm > 0
    return float(np.linalg.norm(got - ref)) / norm


def _moment_within(ref, got, dtype, where):
    """An AdamW moment within the dtype's tolerance of its own scale (in
    L2): the moments are gradient-sized, far below the parameters' floor
    of 1."""
    err = _rel_l2(ref, got)
    assert err <= TOL[dtype], f"{where}: {err:.3e} > {TOL[dtype]}"


def _update_within(before, ref, got, dtype, where):
    """The update ``got - before`` against ``ref - before``: the
    reference moved, the norms agree within the dtype's tolerance, and
    the difference is within :data:`UPDATE_L2` of the reference update's
    norm.  A step that applies no update, or a wrong one, fails."""
    before = np.asarray(before, np.float64)
    d_ref = np.asarray(ref, np.float64) - before
    d_got = np.asarray(got, np.float64) - before
    ratio = float(np.linalg.norm(d_got) / np.linalg.norm(d_ref))
    assert abs(ratio - 1) <= TOL[dtype], f"{where}: |update| ratio {ratio}"
    err = _rel_l2(d_ref, d_got)
    assert err <= UPDATE_L2[dtype], \
        f"{where}: update {err:.3e} > {UPDATE_L2[dtype]}"


def _hold_state(before, ref, got, n, dtype, tol, where=""):
    """A flat (p, m, v) state against the reference's: p within ``tol``
    of scale and its update from ``before`` (the first ``n`` leaves) as
    :func:`_update_within`; m and v as :func:`_moment_within`."""
    assert len(ref) == len(got) == 3 * n
    for i, (a, b) in enumerate(zip(ref, got)):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        if i < n:
            _within(a, b, tol, f"{where}p {i}")
            _update_within(before[i], a, b, dtype, f"{where}p {i}")
        else:
            _moment_within(a, b, dtype, f"{where}{'mv'[i // n - 1]} {i % n}")


def _steps(cf, names, params, m, v, batches, first=0):
    """Run ``cf`` (numpy in/out) over ``batches``; returns (losses, the
    final flat state)."""
    flat = [params[k] for k in names] + [m[k] for k in names] + \
        [v[k] for k in names]
    losses = []
    for i, batch in enumerate(batches):
        outs = cf(batch["tokens"], batch["labels"], np.int32(first + i),
                  *flat)
        losses.append(float(outs[0]))
        flat = list(outs[1:])
    return losses, flat


_JAX_RUNS = {}


def _jax_run(dtype):
    """The JAX package's five steps (its backend at O1) for ``dtype``."""
    if dtype not in _JAX_RUNS:
        cfg = j_get_config("deepseek-7b").reduced(compute_dtype=dtype)
        g = j_lm.build_graphs(cfg, JShapeConfig("train", "train", S, B), B)
        ts = j_tg.make_train_step(g, cfg)
        params = g.builder.init_params(0)
        m, v = j_tg.init_opt_state(g.builder, cfg, params)
        cf = JT.compile(ts.fn, JOptions(level="O1"))
        _JAX_RUNS[dtype] = (ts.fn.signature(),) + _steps(
            cf, ts.param_names, params, m, v, _batches(cfg.vocab))
    return _JAX_RUNS[dtype]


def _batches(vocab, n=STEPS, seed=0):
    data = SyntheticLM(DataConfig(vocab, S, B, seed=seed))
    return [data.batch(s) for s in range(n)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_five_steps_match_the_jax_backend(level, dtype):
    sig, j_losses, j_flat = _jax_run(dtype)
    cfg = get_config("deepseek-7b").reduced(compute_dtype=dtype)
    g = lm.build_graphs(cfg, ShapeConfig("train", "train", S, B), B)
    ts = tg.make_train_step(g, cfg)
    assert ts.fn.signature() == sig
    params = g.builder.init_params(0)
    m, v = tg.init_opt_state(g.builder, cfg, params)
    cf = TB.compile(ts.fn, CompileOptions(level=level,
                                          use_pallas=level == "O2"))
    if level == "O2":
        hits = dict(cf.report.stats)["fuse-compounds"]
        for compound, n in _expected_train().items():
            assert hits.get(compound, 0) >= n, hits
    losses, flat = _steps(cf, ts.param_names, params, m, v,
                          _batches(cfg.vocab))
    assert all(np.isfinite(losses))
    for i, (a, b) in enumerate(zip(j_losses, losses)):
        _within(a, b, TOL[dtype], f"loss at step {i}")
    _hold_state([params[k] for k in ts.param_names], j_flat, flat,
                ts.n_params, dtype, TOL[dtype])


# -- microbatching and LR schedules (tests/test_train_features.py) ------------
def _run_step(ts, params, m, v, toks, lbls, step=0):
    ex = TB.compile(ts.fn)
    args = [toks, lbls, np.int32(step)] + \
        [params[k] for k in ts.param_names] + \
        [m[k] for k in ts.param_names] + [v[k] for k in ts.param_names]
    return ex(*args)


def test_microbatch_matches_full_batch():
    cfg = get_config("deepseek-7b").reduced()
    Bf, Sf, n = 8, 16, 4
    rng = np.random.default_rng(0)
    g1 = lm.build_graphs(cfg, ShapeConfig("train", "train", Sf, Bf), Bf)
    ts1 = tg.make_train_step(g1, cfg)
    g2 = lm.build_graphs(cfg, ShapeConfig("train", "train", Sf, Bf // n),
                         Bf // n)
    ts2 = tg.make_train_step(g2, cfg, n_micro=n)
    params = g1.builder.init_params(0)
    m, v = tg.init_opt_state(g1.builder, cfg, params)
    toks = rng.integers(0, cfg.vocab, size=(Bf, Sf)).astype(np.int32)
    lbls = rng.integers(0, cfg.vocab, size=(Bf, Sf)).astype(np.int32)
    o1 = _run_step(ts1, params, m, v, toks, lbls)
    o2 = _run_step(ts2, g2.builder.init_params(0), m, v, toks, lbls)
    assert abs(float(o1[0]) - float(o2[0])) < 1e-5
    for x, y in zip(o1[1:], o2[1:]):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32),
                                   atol=5e-4, rtol=1e-3)


def test_microbatch_trains():
    cfg = get_config("deepseek-7b").reduced()
    Bf, Sf, n = 8, 16, 2
    g = lm.build_graphs(cfg, ShapeConfig("train", "train", Sf, Bf // n),
                        Bf // n)
    ts = tg.make_train_step(g, cfg, n_micro=n)
    params = g.builder.init_params(0)
    m, v = tg.init_opt_state(g.builder, cfg, params)
    rng = np.random.default_rng(1)
    flat = [params[k] for k in ts.param_names] + \
        [m[k] for k in ts.param_names] + [v[k] for k in ts.param_names]
    ex = TB.compile(ts.fn)
    losses = []
    for step in range(20):
        toks = rng.integers(0, cfg.vocab, size=(Bf, Sf)).astype(np.int32)
        lbls = (toks * 31 + 17) % cfg.vocab
        outs = ex(toks, lbls, np.int32(step), *flat)
        losses.append(float(outs[0]))
        flat = list(outs[1:])
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("sched", ["wsd", "cosine", "constant"])
def test_lr_schedules(sched):
    """The schedule's shape, and its values against the JAX package's."""
    cfg = get_config("minicpm-2b")  # wsd
    c = dataclasses.replace(cfg, schedule=sched, warmup=10,
                            total_steps=100, lr=1.0)
    steps = (0, 5, 9, 10, 50, 89, 95, 99)

    def values(ops, Function, lr_schedule, be, c):
        step_p = ops.parameter((), "i32", "step")
        lr = lr_schedule(c, ops.convert(step_p.out(), "f32"))
        ex = be.compile(Function([step_p], [lr]))
        return [float(ex(np.int32(s))[0]) for s in steps]

    vals = values(ops, Function, tg.lr_schedule, TB, c)
    jc = dataclasses.replace(j_get_config("minicpm-2b"), schedule=sched,
                             warmup=10, total_steps=100, lr=1.0)
    np.testing.assert_allclose(
        vals, values(j_ops, JFunction, j_tg.lr_schedule, JT, jc),
        rtol=1e-6, atol=1e-7)
    assert vals[0] < vals[1] < vals[2] + 1e-6, (sched, vals)  # warmup rises
    assert max(vals) <= 1.0 + 1e-6
    if sched == "wsd":
        assert abs(vals[4] - 1.0) < 1e-6      # stable phase at peak
        assert vals[6] < 1.0                  # decay began
    if sched == "cosine":
        assert vals[7] < vals[4] < vals[3] + 1e-6  # monotone decay
    if sched == "constant":
        assert abs(vals[4] - 1.0) < 1e-6


# -- the CLI -------------------------------------------------------------------
SMALL = ["--reduced", "--log-every", "0"]


def _losses(out):
    m = re.search(r"\[done\] (\d+) steps .* loss (\S+) -> (\S+)", out)
    assert m, out
    return int(m.group(1)), float(m.group(2)), float(m.group(3))


def _ckpt(path, step):
    _, tensors, _ = CheckpointManager(str(path)).restore(step)
    return tensors


def test_cli_trains_on_the_cpu_with_a_falling_loss(tmp_path, capsys):
    assert train_cli.main(["--device", "cpu", "--reduced", "--steps", "20",
                           "--ckpt-dir", str(tmp_path)]) == 0
    n, first, last = _losses(capsys.readouterr().out)
    assert n == 20 and last < first


def test_cli_restart_takes_the_step_from_the_disk_cache(tmp_path, capsys,
                                                        monkeypatch):
    argv = ["--device", "cpu", *SMALL, "--steps", "6", "--ckpt-every", "0",
            "--ckpt-dir", str(tmp_path / "ck"),
            "--cache-dir", str(tmp_path / "cache")]
    for run in ("cold", "warm"):
        # a fresh process: no backend instance carries over
        monkeypatch.setattr(Backend, "_INSTANCES", {})
        assert train_cli.main(argv) == 0
        out = capsys.readouterr().out
        if run == "cold":
            assert "disk_hits=0 disk_misses=1 pipeline ran" in out
        else:
            assert "disk_hits=1 disk_misses=0 pipeline skipped" in out


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_cli_resume_is_bitwise(tmp_path, capsys, level):
    """Eight steps straight, against four steps, a stop, and a resume
    from the step-4 checkpoint: the step-8 state is the same bits."""
    kw = ["--device", "cpu", *SMALL, "--ckpt-every", "4", "--level", level]
    if level == "O2":
        kw.append("--kernels")
    straight, cut = tmp_path / "straight", tmp_path / "cut"
    assert train_cli.main(kw + ["--steps", "8",
                                "--ckpt-dir", str(straight)]) == 0
    assert train_cli.main(kw + ["--steps", "4", "--ckpt-dir", str(cut)]) == 0
    assert train_cli.main(kw + ["--steps", "8", "--ckpt-dir", str(cut),
                                "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"[restore] step 4 from {cut}" in out
    a, b = _ckpt(straight, 8), _ckpt(cut, 8)
    assert sorted(a) == sorted(b) and len(a) > 0
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_between_the_trainers(tmp_path, capsys, writer):
    """Four steps by one package's trainer, then both trainers resume the
    same checkpoint to step 8: each says it restored step 4, and their
    updates from the step-4 parameters and their step-8 moments agree
    as in the five-step case at bf16 compute (the reduced config's)."""
    first = tmp_path / "first"
    clis = {"port": lambda argv: train_cli.main(["--device", "cpu"] + argv),
            "reference": j_train_cli.main}
    assert clis[writer](SMALL + ["--steps", "4", "--ckpt-every", "4",
                                 "--ckpt-dir", str(first)]) == 0
    ends = {}
    for who, cli in clis.items():
        d = tmp_path / who
        CheckpointManager(str(d)).save(4, _ckpt(first, 4),
                                       extra={"arch": "deepseek-7b"})
        capsys.readouterr()
        assert cli(SMALL + ["--steps", "8", "--ckpt-every", "4",
                            "--ckpt-dir", str(d), "--resume"]) == 0
        assert f"[restore] step 4 from {d}" in capsys.readouterr().out, who
        ends[who] = _ckpt(d, 8)
    start = _ckpt(first, 4)
    assert sorted(ends["port"]) == sorted(ends["reference"]) == sorted(start)
    names = sorted(k[2:] for k in start if k.startswith("p/"))
    flat = {who: [end[f"{x}/{k}"] for x in "pmv" for k in names]
            for who, end in ends.items()}
    _hold_state([start[f"p/{k}"] for k in names], flat["reference"],
                flat["port"], len(names), "bf16", TOL["bf16"])


@pytest.mark.cuda
def test_card_step_captured_equals_eager_and_matches_the_cpu():
    """At d_head 128 in f32 (the flash kernel carries the Attention op):
    five captured steps on the card give the eager steps' losses and
    state bit for bit, with the donated state written back into the same
    tensors, and agree with the port on the CPU within 1e-4 of scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    from repro_torch.devices import as_tensor, to_numpy
    cfg = get_config("deepseek-7b").reduced(
        d_model=256, n_heads=2, n_kv_heads=2, d_head=128, d_ff=256,
        compute_dtype="f32")
    g = lm.build_graphs(cfg, ShapeConfig("train", "train", 64, B), B)
    ts = tg.make_train_step(g, cfg)
    n_data, n_p = len(g.builder.inputs), ts.n_params
    donate = tuple(range(n_data + 1, n_data + 1 + 3 * n_p))
    params = g.builder.init_params(0)
    m, v = tg.init_opt_state(g.builder, cfg, params)
    host = [params[k] for k in ts.param_names] + \
        [m[k] for k in ts.param_names] + [v[k] for k in ts.param_names]
    data = SyntheticLM(DataConfig(cfg.vocab, 64, B, seed=0))
    batches = [data.batch(s) for s in range(STEPS)]
    runs = {}
    for static_jit in (True, False):
        cf = Backend.create("torch", fresh=True, device="cuda").compile(
            ts.fn, CompileOptions(level="O2", use_pallas=True,
                                  donate_argnums=donate,
                                  static_jit=static_jit))
        flat = [as_tensor(a.copy(), torch.device("cuda")) for a in host]
        losses = []
        kernels.reset_counters()
        for s, batch in enumerate(batches):
            outs = cf.raw(batch["tokens"], batch["labels"], np.int32(s),
                          *flat)
            losses.append(outs[0].item())
            if static_jit:
                assert all(a is b for a, b in zip(outs[1:], flat))
            flat = list(outs[1:])
        assert kernels.counters()["flash_attention"]["launches"] > 0
        runs[static_jit] = (losses, [to_numpy(t) for t in flat])
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        np.testing.assert_array_equal(a, b)
    cpu = TB.compile(ts.fn, CompileOptions(level="O2", use_pallas=True))
    c_losses, c_flat = _steps(cpu, ts.param_names, params, m, v, batches)
    for a, b in zip(c_losses, runs[True][0]):
        _within(a, b, 1e-4, "loss")
    _hold_state(host[:n_p], c_flat, runs[True][1], n_p, "f32", TOL["f32"])
