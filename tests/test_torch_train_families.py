"""Training the non-dense families at published widths: the CPU side of
``chip_smoke.py``'s phase 15.

  * ``_reckon_train_peak_gb`` is the train builder's parameter census
    times the bytes it states (p, g, m, v, the bf16 casts, the routed
    experts' f32 copies), plus the logits and their gradient and the
    stubbed frames or images;
  * the depth each family trains at: mixtral one layer, deepseek-v3 its
    dense prefix (every ``moe/`` parameter of size 0) with the MTP head,
    recurrentgemma at least one (rec, rec, attn) group, vlm whole
    cross-attention groups, xlstm and whisper at full depth;
  * ``launch/train.py::step_data`` gives step k's frames and images
    whether the run started at 0 or resumed at k;
  * deepseek-v3 with every layer dense (a zero-length MoE Scan) trains
    five f32 steps on the port as on JAX;
  * the emitter's early write of a donated input (``_write_steps``) gives
    the plain run's bits and leaves each output in its input, and
    ``plan_peak_bytes`` counts a plan's live values.
"""
import dataclasses
import functools
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backend import Backend, CompileOptions  # noqa: E402
from repro_torch.backend.graphed import pair_donations  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.function import Function  # noqa: E402
from repro_torch.devices import as_tensor  # noqa: E402
from repro_torch.launch.train import step_data  # noqa: E402
from repro_torch.models.train_graph import init_opt_state  # noqa: E402
from repro_torch.runtime.data import (DataConfig, Prefetcher,  # noqa: E402
                                      SyntheticLM)
from repro_torch.transformers import torch_emit  # noqa: E402

from test_torch_recurrent import five_train_steps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

ARCHS = chip_smoke.TF_ARCHS
BYTES = {"f32": 4, "bf16": 2}


@functools.lru_cache(maxsize=None)
def _depth(arch):
    return chip_smoke._tf_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_census_is_the_builders_parameters_times_the_stated_bytes(arch):
    cfg, ts, _, reckoned, _, _ = _depth(arch)
    params = ts.graphs.builder.params
    n = sum(math.prod(s.shape) for s in params.values())
    experts = sum(math.prod(s.shape) for name, s in params.items()
                  if name.split("/")[-1].startswith("moe_we_"))
    seq = chip_smoke._tf_seq(cfg)
    tokens = chip_smoke.TF_BATCH * seq
    want = n * (2 * BYTES[cfg.param_dtype] + 2 * BYTES[cfg.opt_dtype]) \
        + 2 * n + 4 * experts \
        + tokens * cfg.vocab * 4 * 2 * (2 if cfg.mtp else 1)
    if arch == "whisper-medium":
        want += chip_smoke.TF_BATCH * cfg.enc_seq * cfg.d_model * 4
    if arch == "llama-3.2-vision-11b":
        want += chip_smoke.TF_BATCH * cfg.vision_tokens * cfg.vision_dim * 4
    assert reckoned == pytest.approx(want / 1e9, rel=1e-12)
    assert (experts > 0) == (arch == "mixtral-8x22b")
    assert reckoned < chip_smoke.TF_PEAK_LIMIT_GB


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_each_family_trains_at(arch):
    cfg, ts, _, _, plan, why = _depth(arch)
    full = get_config(arch)
    params = ts.graphs.builder.params
    assert plan < chip_smoke.TF_PEAK_LIMIT_GB
    assert why.startswith(f"{cfg.n_layers} of {full.n_layers} layers")
    assert (cfg.d_model, cfg.vocab) == (full.d_model, full.vocab)
    if arch == "mixtral-8x22b":
        assert cfg.n_layers == 1
    elif arch == "deepseek-v3-671b":
        assert 1 <= cfg.n_layers == cfg.first_dense <= full.first_dense
        moe = [k for k in params if k.startswith("moe/")]
        assert moe and all(math.prod(params[k].shape) == 0 for k in moe)
        assert any(k.startswith("mtp/") for k in params)
    elif arch == "recurrentgemma-9b":
        assert len(cfg.pattern) <= cfg.n_layers < full.n_layers
    elif arch == "llama-3.2-vision-11b":
        assert cfg.n_layers % cfg.cross_every == 0
        assert cfg.cross_every <= cfg.n_layers < full.n_layers
    else:
        assert cfg.n_layers == full.n_layers


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
def test_step_data_is_the_same_from_the_start_or_resumed(arch):
    cfg = get_config(arch).reduced()
    ts, _ = chip_smoke._train_step_graph(cfg, 2, 8)
    b = ts.graphs.builder
    data = SyntheticLM(DataConfig(cfg.vocab, 8, 2, seed=3))
    k = 3

    def run(start):
        pre = Prefetcher(data, start_step=start)
        try:
            got = []
            for step in range(start, k + 2):
                s, batch = pre.next()
                assert s == step
                got.append(step_data(cfg, b, batch, 3, step, 2))
            return got[k - start:]
        finally:
            pre.close()

    for a, r in zip(run(0), run(k)):
        assert len(a) == len(r) == 3
        for x, y in zip(a, r):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_v3_all_dense_train_steps_match_the_jax_backend():
    """Every layer dense (``n_layers == first_dense``): both packages
    build the MoE Scan at length 0 and the same signature; five f32
    steps (moments in f32) agree within the f32 tolerances."""
    five_train_steps("deepseek-v3-671b", "O2", n_layers=2, first_dense=2,
                     opt_dtype="f32")


def _reduced_step(arch, **over):
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    ts, donate = chip_smoke._train_step_graph(cfg, 2, 8)
    cf = Backend.create("torch", device="cpu", fresh=True).compile(
        ts.fn, CompileOptions(level="O2", use_pallas=True,
                              donate_argnums=donate))
    args = chip_smoke._train_batches(cfg, ts, 2, 8, [0])[0] + [np.int32(0)]
    params = ts.graphs.builder.init_params(0)
    m, v = init_opt_state(ts.graphs.builder, cfg, params)
    state = [d[n] for d in (params, m, v) for n in ts.param_names]
    return cf.function, donate, args + state


@pytest.mark.parametrize("arch,over", [
    ("deepseek-7b", {}), ("deepseek-v3-671b", dict(n_layers=1,
                                                    first_dense=1)),
    ("whisper-medium", {})], ids=["dense", "v3-dense", "whisper"])
def test_early_writes_give_the_plain_bits(arch, over):
    """Each donated p, m and v of a train step takes its output early (the
    plan finds a step for every one), and the run that writes them gives
    the bits of the run that does not."""
    fn, donate, host = _reduced_step(arch, **over)
    pairs = pair_donations(fn.in_types, fn.out_types, donate)
    ctx = torch_emit.EmitCtx(torch.device("cpu"), use_pallas=True)
    sl, plan = torch_emit.function_plan(fn, ctx)
    steps = torch_emit._write_steps(sl, plan, pairs)
    assert sorted(i for w in steps.values() for i, _ in w) == sorted(pairs)
    runs = []
    for early in (False, True):
        args = [as_tensor(np.array(a), torch.device("cpu")) for a in host]
        env = [None] * sl.n
        for s, a in zip(sl.params, args):
            env[s] = a
        for s, t in sl.leaves.items():
            env[s] = t
        writes = {t: [(args[i], r) for i, r in w]
                  for t, w in steps.items()} if early else None
        torch_emit._execute(plan, env, ctx, fn.name, writes)
        outs = [env[s] for s in sl.results]
        if early:
            for i, j in pairs.items():
                assert outs[j] is args[i]
        runs.append(outs)
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_plan_peak_bytes_counts_live_values():
    """exp(x) and exp(x) + exp(x) on a 4 x 4 f32: both live at the add
    (128 bytes); a donated x changes nothing of that; a reshape (a view)
    adds nothing."""
    x = ops.parameter((4, 4), "f32", "x")
    y = ops.exp(x.out())
    z = ops.reshape(y + y, (16,))
    fn = Function([x], [ops.reshape(z, (4, 4))], name="f")
    assert torch_emit.plan_peak_bytes(fn) == 128
    assert torch_emit.plan_peak_bytes(fn, {0: 0}) == 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA-graph capture has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_train_step_reads_each_steps_f32_frames(cuda_device):
    """Whisper's train step takes f32 frames for its bf16 ``frames``
    input, as the trainer passes them: the captured replays read each
    step's frames in f32, as the eager run does, and every donated p, m
    and v comes back as its own tensor."""
    cfg = dataclasses.replace(get_config("whisper-medium").reduced(),
                              compute_dtype="bf16")
    ts, donate = chip_smoke._train_step_graph(cfg, 2, 8)
    batches = chip_smoke._train_batches(cfg, ts, 2, 8, range(4))
    params = ts.graphs.builder.init_params(0)
    host = [params[n] for n in ts.param_names]
    host += [np.zeros_like(a) for a in host] * 2
    be = Backend.create("torch", device=cuda_device, fresh=True)
    opts = CompileOptions(level="O2", use_pallas=True, donate_argnums=donate)
    losses = {}
    for jit in (False, True):
        cf = be.compile(ts.fn, opts.replace(static_jit=jit))
        flat = [torch.from_numpy(a.copy()).to(cuda_device) for a in host]
        losses[jit] = []
        for k, batch in enumerate(batches):
            assert batch[0].dtype == np.float32
            outs = cf.raw(*batch, np.int32(k), *flat)
            losses[jit].append(outs[0].item())
            assert all(a is b for a, b in zip(outs[1:], flat))
    assert losses[True] == losses[False]
