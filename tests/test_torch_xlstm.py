"""The recurrent families on torch, part two: xlstm-350m (``xlstm``)
against the JAX package on the CPU, with the helpers and tolerances of
``tests/test_torch_recurrent.py``.

The mLSTM block (parallel form: a cumsum, an S x S decay matrix and
einsums; or one recurrent decode step from its (C, n, m) state) and the
sLSTM block (an IR ``Scan`` over time, which inside the family's groups
``Scan`` runs nested; or one step from its (h, c, n, m) state) are held
alone; every graph kind at torch O1 and O2 against JAX O1; the lockstep
engine's f32 greedy tokens against the JAX engine's; the empty
prefill-to-decode cache map (the reference's prefill exports no state,
so decode starts all seven states from zeros) and the long decode's
constant state; five f32 train steps against the JAX trainer; and the
full-width census of the kernels the card's path launches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402
from repro.models import xlstm as j_xl  # noqa: E402
from repro.models.builder import ModelBuilder as JBuilder  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import ops as t_ops  # noqa: E402
from repro_torch.core.function import Function as TFunction  # noqa: E402
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import xlstm as t_xl  # noqa: E402
from repro_torch.models.builder import ModelBuilder as TBuilder  # noqa: E402
from repro_torch.models.weights import init_params_on_device  # noqa: E402

from test_torch_recurrent import (B, S, _hold, _jax, _port,  # noqa: E402
                                  cache_name_map, five_train_steps,
                                  hold_census, hold_graph,
                                  long_decode_state_is_constant,
                                  lockstep_tokens)

ARCH = "xlstm-350m"
D, H, FF = 64, 4, 128


def _block_fn(ops, Function, Builder, xl, which, dtype, state):
    """``apply_{which}_block`` on a (B, s, D) input: 9 steps in parallel
    form (the sLSTM's time Scan), or one decode step from its state."""
    b = Builder("f32", dtype)
    s = 1 if state else 9
    x = ops.parameter((B, s, D), dtype, "x")
    specs = xl.mlstm_specs(D, H, 2) if which == "mlstm" else \
        xl.slstm_specs(D, H, FF)
    ws = {n: ops.parameter(shape, "f32", n) for n, (shape, _) in
          specs.items()}
    params = [x] + list(ws.values())
    st = None
    if state:
        dm = 2 * D // H
        shapes = ([(B, H, dm, dm), (B, H, dm), (B, H)] if which == "mlstm"
                  else [(B, D)] * 4)
        st = [ops.parameter(sh, "f32", f"state{i}")
              for i, sh in enumerate(shapes)]
        params += st
        st = tuple(p.out() for p in st)
    w = {f"p_{n}": p.out() for n, p in ws.items()}
    if which == "mlstm":
        out, extra = xl.apply_mlstm_block(b, x.out(), w, prefix="p_",
                                          n_heads=H, proj=2, state=st)
    else:
        out, extra = xl.apply_slstm_block(b, x.out(), w, prefix="p_",
                                          n_heads=H, d_ff=FF, state=st)
    return Function(params, [out] + list(extra), which)


@pytest.mark.parametrize("state", [False, True],
                         ids=["parallel", "decode_state"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_blocks_match_jax(which, dtype, state):
    """The mLSTM and sLSTM blocks at torch O1 and O2 against JAX, with
    their new decode states."""
    rng = np.random.default_rng(6)
    jfn = _block_fn(j_ops, JFunction, JBuilder, j_xl, which, dtype, state)
    tfn = _block_fn(t_ops, TFunction, TBuilder, t_xl, which, dtype, state)
    assert jfn.signature() == tfn.signature()
    args = []
    for p in jfn.parameters:
        t = p.out_types[0]
        fan = t.shape[-2] if len(t.shape) >= 2 and p.name.startswith(
            ("w", "ffn")) else 1
        args.append((rng.normal(size=t.shape) / np.sqrt(fan))
                    .astype(np.float32).astype(t.dtype))
    ref = _jax(jfn, args)
    for level in ("O1", "O2"):
        got = _port(tfn, args, level)
        assert len(got) == len(ref) == (1 if not state else
                                        4 if which == "mlstm" else 5)
        for i, (a, b) in enumerate(zip(ref, got)):
            _hold(f"{which} {level} output {i}", a, b, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode",
                                  "long_decode"])
def test_graph_matches_jax(kind, dtype):
    """Every graph kind of the reduced family (two (mLSTM, sLSTM) groups;
    the sLSTM's time Scan nested in the groups Scan), torch O1 and O2
    against JAX O1."""
    hold_graph(ARCH, kind, dtype)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_lockstep_tokens_match_jax(level):
    """``ServeEngine(mode="lockstep")`` serves the family: f32 greedy
    tokens equal the JAX engine's."""
    jt, tt = lockstep_tokens(ARCH, level)
    assert tt == jt


def test_lockstep_decode_starts_every_state_from_zeros():
    """The reference's property the port copies: xlstm's prefill exports
    no state (its last-token logits only), so the lockstep decode's
    seven states start at zero."""
    cfg = get_config(ARCH).reduced(compute_dtype="f32")
    eng = ServeEngine(cfg, EngineConfig(mode="lockstep", slots=B,
                                        max_len=S, device="cpu"))
    g, cf, pvals = eng._prefill_for(6, B)
    prompts = np.zeros((B, 6), np.int32)
    outs = cf(prompts, *pvals)
    assert len(outs) == 1 and g.aux["cache_names"] == []
    caches = eng._init_caches(g, outs[1:])
    assert eng.cache_names == eng.graphs.aux["state_out_names"] == [
        "m_C", "m_n", "m_m", "s_h", "s_c", "s_n", "s_m"]
    assert all(c.dtype == np.float32 and not c.any() for c in caches)


def test_cache_name_map_prefill_to_decode():
    names, out_names = cache_name_map(ARCH)
    assert names == []
    assert out_names == ["m_C", "m_n", "m_m", "s_h", "s_c", "s_n", "s_m"]


def test_long_decode_state_does_not_grow_with_context():
    long_decode_state_is_constant(ARCH)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_five_train_steps_match_the_jax_backend(level):
    five_train_steps(ARCH, level)


def test_init_on_device_draws_the_xlstm_initializers():
    """``init_params_on_device`` covers the blocks' initializers: fan-in
    for the projections, ``normal_init(0.02)`` for the gate weights,
    zeros for the gate biases, ones for the FFN norm."""
    cfg = get_config(ARCH).reduced(d_model=256)
    b = lm.build_graphs(cfg, ShapeConfig("decode", "decode", S, B),
                        B).builder
    got = init_params_on_device(b, 0, "cpu")
    assert set(got) == set(b.param_names())
    for spec in b.params.values():
        assert tuple(got[spec.name].shape) == tuple(spec.shape)
    g = {n.split("/")[-1]: t for n, t in got.items()
         if n.startswith("groups/")}
    for name, std in (("m_w_up", 256 ** -0.5), ("m_wq", 512 ** -0.5),
                      ("m_w_if", 0.02), ("s_w_gates", 0.02),
                      ("s_r_gates", 0.02)):
        assert abs(float(g[name].float().std()) / std - 1) < 0.1, name
    assert not g["m_b_if"].any() and not g["s_b_gates"].any()
    assert bool((g["s_ffn_norm_g"] == 1).all())


def test_serve_cli_lockstep_smoke(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", ARCH, "--reduced", "--mode", "lockstep",
                     "--device", "cpu", "--level", "O2", "--kernels",
                     "--prompt-len", "8", "--gen", "6", "--smoke"])
    out = capsys.readouterr().out
    assert rc == 0 and "[serve:lockstep]" in out and "[smoke] ok" in out


def test_full_width_xlstm_launches_the_written_kernels():
    """xlstm-350m at full width and depth (``chip_smoke.py`` phase 10's
    batch of 4; a 16-token prefill, since the kernels' shapes differ from
    the 128-token one's only in rows): matmul, norm_matmul and rmsnorm
    launch, no flash (no Attention op), and nothing is refused -- the
    gate projection ``w_if`` (N = 8) included."""
    hold_census(get_config(ARCH), [("prefill", 16, 4), ("decode", 144, 4)], 0)
