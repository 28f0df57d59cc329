"""The multimodal families on torch -- whisper-medium (``encdec``) and
llama-3.2-vision-11b (``vlm``) -- against the JAX package on the CPU.

Both packages build the same graphs (their structural signatures agree)
and run them on the same numpy inputs and weights (the JAX builder's, or
the JAX engine's, carried across by name with ``params_from_numpy``).
vlm's cross-attention gates start at zero (``zeros_init``), which makes
its cross blocks add exactly nothing, so wherever cross-attention
numerics are meant to count the gates are set to 0.5 in both packages;
the graph tests feed whisper's ``cross_k``/``cross_v`` and vlm's
``vis_k``/``vis_v`` non-zero.  Tolerances are
``scripts/check_kernel_parity.py``'s: 1e-4 of scale in f32, 3e-2 in
bf16, with identical logits argmax; greedy tokens are identical.  The
helpers are ``tests/test_torch_recurrent.py``'s.

vlm's reduced config is 12 blocks deep (two groups of a cross block and
five self blocks), where the other families' are 2-5.  At that depth
bf16 rounding alone moves the reference's own numpy interpreter 2.1-3.9%
of scale off JAX in prefill and decode (and a 12-layer reduced
deepseek-7b's decode 9%), so vlm's bf16 graphs are held at two groups of
one cross and one self block (``VLM_BF16``: the same structure, four
blocks; the interpreter 1.3-2.2% off JAX there); f32 is held at the
reduced depth.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.backend import CompileOptions as JOptions  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.backend import CompileOptions  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.launch.serve import (full_width_builder,  # noqa: E402
                                      smoke_kernels)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import (init_params_on_device,  # noqa: E402
                                        params_from_numpy)

from test_torch_recurrent import (B, S, _cfg, _hold, _jax,  # noqa: E402
                                  _port, five_train_steps, full_width_census,
                                  graphs, inputs)

WHISPER, VLM = "whisper-medium", "llama-3.2-vision-11b"
ARCHS = (WHISPER, VLM)
GATES = ("groups/x_gate_attn", "groups/x_gate_ffn")
# the d_head-64 width: whisper's full-width head, which flash carries on
# the card (FLASH_HEAD_MULTIPLE); vlm takes it there at 128
DH64 = dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=64, d_ff=256)
# vlm's bf16 depth: two groups of one gated cross block and one self block
VLM_BF16 = dict(n_layers=2, cross_every=1)


def _open_gates(params) -> None:
    """vlm's cross-attention gates to tanh(0.5), in place (the JAX
    lockstep engine reads these very arrays)."""
    for name in GATES:
        if name in params:
            params[name][...] = 0.5


def _graph_args(arch, kind, dtype):
    over = VLM_BF16 if (arch, dtype) == (VLM, "bf16") else {}
    jc, tc, jg, tg = graphs(arch, kind, dtype, **over)
    args = inputs(jg, jc, np.random.default_rng(5))
    names = jg.builder.param_names()
    n_data = len(jg.builder.inputs)
    for name in GATES:
        if name in names:
            i = n_data + names.index(name)
            args[i] = np.full_like(args[i], 0.5)
    for node, a in zip(jg.builder.inputs, args):
        if node.name in ("cross_k", "cross_v", "vis_k", "vis_v", "frames",
                         "images"):
            assert np.asarray(a, np.float32).any(), node.name
    return jg, tg, args


# -- every graph kind ------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_matches_jax(arch, kind, dtype):
    """Every graph kind of the reduced family at torch O2 (the kernels'
    plain versions) against JAX O1, output by output, on the builder's
    weights (vlm's gates open) and non-zero stubbed frames or images and
    cross caches."""
    jg, tg, args = _graph_args(arch, kind, dtype)
    ref = _jax(jg.fn, args)
    got = _port(tg.fn, args, "O2")
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        _hold(f"{kind} output {i}", a, b, dtype)
    if kind != "train":
        assert np.array_equal(np.asarray(ref[0], np.float32).argmax(-1),
                              np.asarray(got[0], np.float32).argmax(-1))


def test_cross_attention_counts_in_the_decode():
    """The decode's cross-attention reads its caches: zeroing whisper's
    ``cross_k``/``cross_v`` or vlm's ``vis_k``/``vis_v`` (gates open)
    moves the logits."""
    for arch, names in ((WHISPER, ("cross_k", "cross_v")),
                        (VLM, ("vis_k", "vis_v"))):
        jg, tg, args = _graph_args(arch, "decode", "f32")
        full = np.asarray(_port(tg.fn, args, "O1")[0])
        for i, node in enumerate(tg.builder.inputs):
            if node.name in names:
                args[i] = np.zeros_like(args[i])
        zero = np.asarray(_port(tg.fn, args, "O1")[0])
        assert np.abs(full - zero).max() > 1e-3, arch


# -- the lockstep engine ------------------------------------------------------------
def _ulp(x: float) -> float:
    """One bf16 unit in the last place at the magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(x)), 2.0 ** -14))) - 7)


def _divergence_witness(eng, prompts, jtoks, ttoks):
    """For each request whose port tokens differ from JAX's: the first
    step that differs, and that step's logits from the port's dense
    (1, P) prefill of the prompt plus the tokens both agree on, on the
    request's own row of the engine's stubbed frames or images -- its
    top two and their gap in bf16 units in the last place
    (``tests/test_torch_engine_modes.py``'s witness)."""
    gb, _, _ = eng._prefill_for(len(prompts[0]), len(prompts))
    media = [a for node, a in zip(gb.builder.inputs, eng._prefill_inputs(
        gb, np.stack(prompts))) if node.name != "tokens"]
    found = []
    for r, (jt, tt) in enumerate(zip(jtoks, ttoks)):
        differ = [i for i, (a, b) in enumerate(zip(jt, tt)) if a != b]
        if not differ:
            continue
        j = differ[0]
        seq = np.concatenate([prompts[r], jt[:j]]).astype(np.int32)
        g, cf, pvals = eng._prefill_for(len(seq), 1)
        rows = iter(m[r:r + 1] for m in media)
        outs = cf(*[seq.reshape(1, -1) if node.name == "tokens"
                    else next(rows) for node in g.builder.inputs], *pvals)
        lg = np.asarray(outs[0], np.float32).reshape(-1)
        a, b = (int(t) for t in np.argsort(-lg, kind="stable")[:2])
        found.append({"request": r, "step": j, "jax_token": jt[j],
                      "port_token": tt[j], "top2": [a, b],
                      "gap_ulps": float(lg[a] - lg[b]) / _ulp(lg[a])})
    return found


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_runs_multimodal_families(arch):
    """``tests/test_engine.py::test_lockstep_runs_multimodal_families`` on
    torch: the reduced family's prefill takes stubbed frames or images
    and declares weights the decode graph does not (whisper's encoder,
    vlm's vision projection); lockstep threads both.  The reduced config
    computes in bf16, so its greedy tokens equal the JAX engine's (on
    the JAX engine's weights) except where a witness shows the port's
    top two logits within one bf16 unit, the two packages' picks being
    those two (f32 tokens are identical: the next test)."""
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    assert cfg.compute_dtype == "bf16"
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=(4,)) for _ in range(2)]
    jeng = JServeEngine(jcfg, slots=2, max_len=10, mode="lockstep", seed=0)
    jr = [jeng.submit(p, 6) for p in prompts]
    jrep = jeng.run()
    eng = ServeEngine(cfg, EngineConfig(
        mode="lockstep", slots=2, max_len=10, seed=0, device="cpu",
        params=params_from_numpy(jeng.params, "cpu")))
    rids = [eng.submit(p, 6) for p in prompts]
    rep = eng.run()
    assert all(len(rep.results[r]) == 6 for r in rids)
    assert rep.decode_tok_s > 0
    jtoks = [jrep.results[r].tolist() for r in jr]
    ttoks = [rep.results[r].tolist() for r in rids]
    for w in _divergence_witness(eng, prompts, jtoks, ttoks):
        assert w["gap_ulps"] <= 1, w
        assert {w["jax_token"], w["port_token"]} == set(w["top2"]), w


@pytest.mark.parametrize("arch,level,width", [
    (WHISPER, "O2", "dh64"), (VLM, "O1", "reduced"), (VLM, "O2", "dh128")])
def test_lockstep_tokens_match_jax(arch, level, width):
    """f32 greedy tokens of both lockstep engines, 2 slots of 12 prompt
    tokens and 8 new ones, vlm's gates open in both: equal.  At O2 the
    port takes flash where the head is a multiple of 64 (the plain
    version here) and JAX its Pallas kernels in interpret mode."""
    over = dict(DH64) if width == "dh64" else {}
    jcfg = _cfg(j_get_config, arch, "f32", width, **over)
    tcfg = _cfg(get_config, arch, "f32", width, **over)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab, 12).astype(np.int32)
               for _ in range(B)]
    jeng = JServeEngine(jcfg, mode="lockstep", slots=B, max_len=24,
                        options=JOptions(level=level,
                                         use_pallas=level == "O2",
                                         interpret_pallas=True))
    _open_gates(jeng.params)
    jr = [jeng.submit(p, 8) for p in prompts]
    jrep = jeng.run()
    teng = ServeEngine(tcfg, EngineConfig(
        mode="lockstep", slots=B, max_len=24, device="cpu",
        params=params_from_numpy(jeng.params, "cpu")),
        options=CompileOptions(level=level, use_pallas=level == "O2"))
    tr = [teng.submit(p, 8) for p in prompts]
    trep = teng.run()
    assert all(trep.statuses[r] == "completed" for r in tr), trep.errors
    assert [trep.results[r].tolist() for r in tr] == \
        [jrep.results[r].tolist() for r in jr]


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_decode_cross_attends_over_zeros(arch):
    """The reference's property the port copies: the prefill exports the
    self-attention caches only, so the lockstep decode's cross caches
    (whisper's encoder projections, vlm's image keys and values) are
    step constants that start and stay zero, while the self caches hold
    the prefill's rows."""
    cfg = _cfg(get_config, arch)
    eng = ServeEngine(cfg, EngineConfig(mode="lockstep", slots=B,
                                        max_len=S, device="cpu"))
    P = 6
    g, cf, pvals = eng._prefill_for(P, B)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P)).astype(np.int32)
    outs = cf(*eng._prefill_inputs(g, prompts), *pvals)
    caches = dict(zip(eng.cache_names, eng._init_caches(g, outs[1:])))
    consts = set(caches) - set(eng.graphs.aux["state_out_names"])
    assert consts == ({"cross_k", "cross_v"} if arch == WHISPER
                      else {"vis_k", "vis_v"})
    for name, c in caches.items():
        if name in consts:
            assert eng._recycle[eng.cache_names.index(name)] is None
            assert not np.asarray(c, np.float32).any(), name
        else:
            got = np.asarray(outs[1 + g.aux["cache_names"].index(name)])
            assert np.array_equal(c[:, :, :, :P], got), name
            assert not np.asarray(c[:, :, :, P:], np.float32).any(), name


@pytest.mark.parametrize("mode", ["lockstep", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_multimodal_families_serve_through_lockstep_only(arch, mode):
    """Each family builds its decode graph and serves through lockstep;
    the other modes refuse at construction with the reference's
    message (paged here; ``tests/test_torch_moe.py`` holds all three)."""
    cfg = get_config(arch).reduced()
    if mode == "lockstep":
        assert lm.build_graphs(cfg, ShapeConfig("decode", "decode", 16, 2),
                               2).aux["cache_names"]
        eng = ServeEngine(cfg, EngineConfig(mode=mode, slots=2, max_len=16,
                                            device="cpu"))
        rid = eng.submit(np.arange(5, dtype=np.int32), 3)
        assert len(eng.run().results[rid]) == 3
        return
    with pytest.raises(NotImplementedError) as jerr:
        JServeEngine(j_get_config(arch).reduced(), mode=mode, slots=2,
                     max_len=16)
    with pytest.raises(NotImplementedError) as terr:
        ServeEngine(cfg, EngineConfig(mode=mode, slots=2, max_len=16,
                                      device="cpu"))
    assert str(terr.value) == str(jerr.value)


# -- training ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_five_train_steps_match_the_jax_backend(arch):
    """Five f32 train steps at O2 (the stubbed frames or images drawn as
    the trainer draws them) against JAX's: losses, parameters, moments
    and each update's direction (``UPDATE_L2``)."""
    five_train_steps(arch, "O2")


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_cli_trains_the_reduced_arch(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch ... --reduced --device
    cpu``: the trainer feeds the family's frames or images, and the loss
    falls (exit 0)."""
    from repro_torch.launch import train
    rc = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--steps", "12", "--batch", "2", "--seq", "16",
                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[done] 12 steps on cpu" in out


# -- weights -------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_on_device_draws_the_multimodal_initializers(arch):
    """``init_params_on_device`` over the prefill builder (the one that
    declares every weight): the builder's shapes and dtypes, zeros where
    the builder's init is zeros (the blocks' LayerNorm biases, vlm's
    gates), ones for the norm gains, the builder's spread elsewhere."""
    cfg = get_config(arch).reduced(d_model=128)
    b = full_width_builder(cfg, 16, 2)
    got = init_params_on_device(b, 0, "cpu")
    assert set(got) == set(b.param_names())
    ref = b.init_params(0)
    for spec in b.params.values():
        t = got[spec.name]
        assert tuple(t.shape) == tuple(spec.shape) and \
            t.dtype == torch.float32, spec.name
        arr = ref[spec.name]
        if arr.std() == 0:        # zeros / ones initializers
            assert np.array_equal(t.numpy(), arr), spec.name
        else:
            assert abs(float(t.std()) / float(arr.std()) - 1) < 0.2, \
                spec.name
    zeros = [n for n in got if not got[n].any()]
    if arch == WHISPER:
        assert {"enc/ln1_b", "dec/lnx_b", "final_norm/b"} <= set(zeros)
    else:
        assert set(GATES) <= set(zeros)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_weights_cover_the_prefill(arch):
    """``serve.py``'s full-width draw covers both graphs: the prefill's
    names are the decode graph's plus the encoder's (whisper) or the
    vision projection's (vlm), so the engine draws nothing on the
    host."""
    cfg = get_config(arch)
    names = set(full_width_builder(cfg, 80, 4).param_names())
    dec = set(lm.build_graphs(cfg, ShapeConfig("decode", "decode", 80, 4),
                              4).builder.param_names())
    extra = names - dec
    assert dec < names
    if arch == WHISPER:
        assert "enc_norm/g" in extra and all(
            n.startswith("enc") for n in extra)
    else:
        assert extra == {"vision_proj/w"}
    # the engine keeps every given weight, so the prefill needs no draw
    small = get_config(arch).reduced()
    params = full_width_builder(small, 16, 2).init_params(3)
    eng = ServeEngine(small, EngineConfig(mode="lockstep", slots=2,
                                          max_len=16, device="cpu",
                                          params=params))
    g, _, pvals = eng._prefill_for(4, 2)
    for n, v in zip(g.builder.param_names(), pvals):
        assert np.array_equal(v.numpy(), params[n]), n


# -- the serving CLI -----------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_falls_back_to_lockstep(arch, capsys):
    """Without ``--mode`` the CLI prints the reference's notice and serves
    the family through lockstep (O2, the kernels' plain versions)."""
    from repro_torch.launch import serve
    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--level", "O2", "--kernels", "--prompt-len", "8",
                     "--gen", "6", "--smoke"])
    out = capsys.readouterr().out
    cfg = get_config(arch).reduced()
    assert rc == 0 and "[serve:lockstep]" in out and "[smoke] ok" in out
    assert (f"[serve] {cfg.name} ({cfg.family}): no serve/chunk graphs "
            f"yet, falling back to --mode lockstep") in out


# -- full width: the kernels the card's path launches -------------------------------
def test_smoke_kernels_name_the_multimodal_paths():
    """whisper: LayerNorm and a GeLU MLP, so matmul and flash (its heads
    are 64 wide), and the batched kernel for its tied unembedding; vlm:
    all five ported kernels.  Neither may refuse."""
    assert smoke_kernels(get_config(WHISPER)) == (
        {"matmul", "flash_attention", "batched_matmul"}, set())
    assert smoke_kernels(get_config(VLM)) == (
        set(kernels.MODULES) - {"batched_matmul"}, set())


@pytest.mark.parametrize("arch,cases", [
    (WHISPER, [("prefill", 64, 4, 72), ("decode", 80, 4, 48)]),
    (VLM, [("prefill", 128, 4, 48), ("decode", 144, 4, 48)])],
    ids=["whisper", "vlm"])
def test_full_width_census_equals_smoke_kernels(arch, cases):
    """At full width and depth, at ``chip_smoke.py`` phase 11's shapes, a
    meta-device walk launches exactly the kernels ``smoke_kernels``
    names, refuses none (whisper's tied 51865-wide unembedding, whose
    contraction runs over the table's second axis, is the batched
    kernel's), and calls flash once
    per Attention op: whisper 24 encoder + 24 self + 24 cross per
    prefill and 24 + 24 per decode step, vlm 8 cross + 40 self."""
    cfg = get_config(arch)
    need, may_refuse = smoke_kernels(cfg)
    for kind, seq, batch, flash in cases:
        launched, refused = full_width_census(cfg, kind, seq, batch)
        assert set(launched) == need, (kind, launched)
        assert set(refused) <= may_refuse and not refused, (kind, refused)
        assert launched["flash_attention"] == flash, (kind, launched)


def test_vlm_depth_census_matches_the_published_stack():
    """vlm at full depth is 8 groups of one gated cross block and five
    self blocks: 11.6 B parameters, the figure ``chip_smoke.py`` phase 11
    sizes the card's memory by."""
    cfg = get_config(VLM)
    n = full_width_builder(cfg, 144, 4).n_params()
    assert 11.5e9 < n < 11.7e9, n
    half = dataclasses.replace(cfg, n_layers=20)
    assert full_width_builder(half, 144, 4).n_params() < n * 0.55


# -- on the card -------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_lockstep_matches_the_cpu_in_f32(arch):
    """At flash head widths in f32 (whisper 64, vlm 128), gates open:
    lockstep on the card gives the CPU's greedy tokens, and every kernel
    ``smoke_kernels`` names launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    width = "dh64" if arch == WHISPER else "dh128"
    cfg = _cfg(get_config, arch, "f32", width,
               **(DH64 if arch == WHISPER else {}))
    params = full_width_builder(cfg, 24, B).init_params(0)
    _open_gates(params)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, 12).astype(np.int32)
               for _ in range(B)]
    toks = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_counters()
        eng = ServeEngine(cfg, EngineConfig(
            mode="lockstep", slots=B, max_len=24, device=dev,
            params=params_from_numpy(params, dev)),
            options=CompileOptions(level="O2", use_pallas=True))
        rids = [eng.submit(p, 8) for p in prompts]
        rep = eng.run()
        toks[dev] = [rep.results[r].tolist() for r in rids]
        if dev == "cuda":
            counts = kernels.counters()
    assert toks["cuda"] == toks["cpu"]
    need, _ = smoke_kernels(cfg)
    assert all(counts[k]["launches"] > 0 for k in need), counts
