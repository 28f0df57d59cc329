"""The partition pass, the sharding API, the collectives and the shard
executor on torch, against the reference.

- The pass (``repro_torch.core.passes.partition``, a copy of the
  reference's): the cases of ``tests/test_partition.py`` -- collective
  insertion per sharding pattern, idempotence, ``simulate_shards``
  against the interpreter, the pipeline's stats -- and on the same small
  graphs the port's partitioned graph has the reference's signature and
  stats.  On reduced deepseek-7b's paged decode chunk and paged prefill
  chunk at O1 and O2 the signatures and stats equal the reference's
  (the values ``scripts/check_torch_parity.py --kind tp`` prints).
- The shard executor (``repro_torch.backend.sharded``) against the
  port's ``simulate_shards`` on the partitioned paged chunk in f32:
  within 1e-4 of scale, and the pool outputs (gathers and copies of
  pages) exactly.
- The collectives: the cases of ``tests/test_collectives.py`` and the
  shard_map data-parallel case of ``tests/test_train_features.py``
  through ``sharded.shard_map`` on CPU meshes, against numpy's
  semantics; the guard message outside a group.
- The API: the profiles, policies and option messages equal the
  reference's (``tests/test_sharding_api.py`` without the shims, which
  are not ported, and the policy cases of ``tests/test_runtime.py``);
  ``mesh_for_options`` builds CPU meshes and, on CUDA with too few
  cards, raises naming the shared-card mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import CompileOptions as JOptions  # noqa: E402
from repro.backend import OptionsError as JOptionsError  # noqa: E402
from repro.backend import sharding as j_sharding  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402
from repro.core.passes import PartitionGraph as JPartitionGraph  # noqa: E402
from repro.core.passes import run_pipeline as j_run_pipeline  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402

from repro_torch.backend import (Backend, CompileOptions,  # noqa: E402
                                 OptionsError, sharding)
from repro_torch.backend.sharded import shard_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.autodiff import GradBuilder, grad  # noqa: E402
from repro_torch.core.function import Function  # noqa: E402
from repro_torch.core.passes import (CompressAllReduce,  # noqa: E402
                                     PartitionGraph, PassStats,
                                     simulate_shards, standard_pipeline)
from repro_torch.core.passes import run_pipeline  # noqa: E402
from repro_torch.core.passes.cse import CSE  # noqa: E402
from repro_torch.transformers.interpreter import \
    evaluate as EVAL_FN  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.transformers.torch_emit import EMIT, EmitCtx  # noqa: E402

RNG = np.random.default_rng(10)
TP = PartitionGraph({"ffn": "model"}, {"model": 2}, last_dim_only=True)
ROW = PartitionGraph({"ffn": "model"}, {"model": 2}, last_dim_only=False)
FUSE = {"swiglu": True, "norm_matmul": True, "rotary_qkv": True}


def _param(ops, shape, logical=None, name=None):
    p = ops.parameter(shape, "f32", name)
    if logical is not None:
        p.attrs["logical_axes"] = tuple(logical)
    return p


def _mlp(ops=ops, Function=Function):
    """x @ w1 (column-sharded) -> relu -> @ w2 (replicated)."""
    x = _param(ops, (2, 8), name="x")
    w1 = _param(ops, (8, 16), (None, "ffn"), name="w1")
    w2 = _param(ops, (16, 4), name="w2")
    y = ops.matmul(ops.relu(ops.matmul(x.out(), w1.out())), w2.out())
    return Function([x, w1, w2], [y])


def _row_mlp(ops=ops, Function=Function):
    x = _param(ops, (2, 8), name="x")
    w1 = _param(ops, (8, 16), (None, "ffn"), name="w1")
    w2 = _param(ops, (16, 4), ("ffn", None), name="w2")
    y = ops.matmul(ops.matmul(x.out(), w1.out()), w2.out())
    return Function([x, w1, w2], [y])


def _forced(ops=ops, Function=Function):
    """A sharded rank-1 bias broadcast onto the sharded activation, a
    replicated constant pushed through its broadcast, and a reshape that
    splits and merges the sharded dim."""
    x = _param(ops, (2, 8), name="x")
    w = _param(ops, (8, 16), (None, "ffn"), name="w")
    b = _param(ops, (16,), ("ffn",), name="b")
    w2 = _param(ops, (16, 4), name="w2")
    h = ops.matmul(x.out(), w.out())
    h = h + ops.broadcast_in_dim(b.out(), (2, 16), (1,))
    h = h + ops.broadcast_in_dim(
        ops.constant(np.linspace(-1, 1, 16, dtype=np.float32)), (2, 16), (1,))
    z = ops.reshape(ops.reshape(h, (2, 2, 8)), (2, 16))
    y = ops.matmul(z, w2.out())
    return Function([x, w, b, w2], [y, h])


def _fallback(ops=ops, Function=Function):
    x = _param(ops, (4, 16), (None, "ffn"), name="x")
    return Function([x], [ops.reduce_sum(ops.exp(x.out()), axes=(1,))])


def _inputs(fn):
    return [RNG.normal(size=p.out_types[0].shape).astype(np.float32)
            for p in fn.parameters]


def _interp(fn, ins):
    return Backend.create("interpreter", fresh=True).compile(fn)(*ins)


def _cpu():
    return Backend.create("torch", fresh=True, device="cpu")


# -- the pass: the reference's cases and graphs ---------------------------
GRAPHS = {"column": (_mlp, TP), "row": (_row_mlp, ROW),
          "last_dim_only": (_row_mlp, TP), "forced": (_forced, TP),
          "fallback": (_fallback, TP)}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_partition_matches_the_reference_pass(case):
    """Each small graph partitioned by the port's pass and by the
    reference's: the same signature and the same stats; the port's runs
    over simulated groups (``simulate_shards``) as the interpreter does
    on one device."""
    make, pg = GRAPHS[case]
    new, stats = pg.run(make())
    jpg = JPartitionGraph(pg.rules, pg.sizes, pg.last_dim_only, pg.anywhere)
    jnew, jstats = jpg.run(make(j_ops, JFunction))
    assert new.signature() == jnew.signature()
    assert dict(stats) == dict(jstats)
    fn = make()
    ins = _inputs(fn)
    got = simulate_shards(new, ins, {"model": 2})
    for g, r in zip(got, _interp(fn, ins)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=1e-4, atol=1e-5)


def test_column_parallel_inserts_one_all_gather():
    new, stats = TP.run(_mlp())
    assert (stats["params_sharded"], stats["all_gather"]) == (1, 1)
    assert stats.get("all_reduce", 0) == 0
    assert new.op_counts().get("AllGather") == 1
    x2, w1_2, w2_2 = new.parameters
    assert w1_2.out_types[0].shape == (8, 8)
    assert w1_2.attrs["pspec"] == (None, "model")
    assert x2.attrs["pspec"] == w2_2.attrs["pspec"] == (None, None)
    assert new.results[0].node.attrs["out_pspecs"][0] == (None, None)


def test_row_parallel_and_last_dim_only():
    new, stats = ROW.run(_row_mlp())
    assert stats["params_sharded"] == 2 and stats["all_reduce"] >= 1
    assert new.parameters[2].out_types[0].shape == (8, 4)
    exact, st = TP.run(_row_mlp())
    assert st["params_sharded"] == 1 and st.get("all_reduce", 0) == 0
    assert exact.parameters[2].out_types[0].shape == (16, 4)


def test_partition_idempotent():
    new, _ = TP.run(_mlp())
    again, stats = TP.run(new)
    assert again is new and stats == {"already_partitioned": 1}


def test_profile_seeding_and_pipeline_stats():
    prof = sharding.partition_profile("tp")
    pg = PartitionGraph.from_profile(prof, (2,))
    out_fn, report = standard_pipeline("O1", partition=pg).run(_mlp())
    assert isinstance(report.stats, PassStats)
    st = report.stats["partition"]
    assert (st["params_sharded"], st["all_gather"], st["params_total"]) \
        == (1, 1, 3)
    with pytest.raises(KeyError):
        report.stats["no-such-pass"]
    assert out_fn.op_counts()["AllGather"] == 1
    with pytest.raises(ValueError):
        prof.axis_sizes((2, 2))


@pytest.mark.parametrize("mesh_shape", [(1,), (2,)])
def test_backend_shardmap_partition(mesh_shape):
    """``CompileOptions(partition=..., mesh_shape=...)`` drives the pass
    inside ``Backend.compile``; the torch backend runs the shards on the
    CPU and equals the interpreter."""
    fn = _forced()
    ins = _inputs(fn)
    cf = _cpu().compile(fn, CompileOptions(
        mode="shardmap", partition="tp", mesh_shape=mesh_shape, level="O1"))
    st = cf.report.stats.get("partition")
    assert st is not None and st["params_total"] == 4
    assert st.get("params_sharded", 0) == (2 if mesh_shape == (2,) else 0)
    for g, r in zip(cf(*ins), _interp(fn, ins)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


# -- the paged graphs against the reference's ----------------------------
SHAPE = dict(max_len=32, slots=2, steps=2, page_size=4, n_pages=17, chunk=8)


def _paged(lm, cfg, kind):
    s = SHAPE
    if kind == "paged_chunk":
        return lm.build_dense_chunk(cfg, s["max_len"], s["slots"],
                                    s["steps"], page_size=s["page_size"],
                                    n_pages=s["n_pages"])
    return lm.build_dense_paged_prefill(cfg, s["max_len"], s["chunk"],
                                        page_size=s["page_size"],
                                        n_pages=s["n_pages"])


# the values the reference's pass gives on reduced deepseek-7b
PAGED_STATS = {
    ("paged_chunk", "O1"): dict(params_sharded=21, all_gather=2,
                                scan_bodies=2),
    ("paged_chunk", "O2"): dict(params_sharded=17, all_gather=7,
                                scan_bodies=2),
    ("paged_prefill", "O1"): dict(params_sharded=14, all_gather=2,
                                  scan_bodies=1),
    ("paged_prefill", "O2"): dict(params_sharded=14, all_gather=9,
                                  scan_bodies=1),
}


@pytest.mark.parametrize("kind, level", sorted(PAGED_STATS))
def test_paged_graphs_partition_as_the_reference(kind, level):
    """Reduced deepseek-7b's paged graphs through each package's
    pipeline with the tp profile's pass last: one signature, one set of
    stats, and those the reference gives (no AllReduce: the exact
    profile never splits a contraction)."""
    prof = sharding.partition_profile("tp")
    jprof = j_sharding.partition_profile("tp")
    jfn, jrep = j_run_pipeline(
        _paged(j_lm, j_get_config("deepseek-7b").reduced(), kind).fn, level,
        fuse=FUSE, partition=JPartitionGraph.from_profile(jprof, (2,)))
    tfn, trep = run_pipeline(
        _paged(lm, get_config("deepseek-7b").reduced(), kind).fn, level,
        fuse=FUSE, partition=PartitionGraph.from_profile(prof, (2,)))
    assert tfn.signature() == jfn.signature()
    st = dict(trep.stats["partition"])
    assert st == dict(jrep.stats["partition"])
    assert {k: st.get(k, 0) for k in PAGED_STATS[kind, level]} == \
        PAGED_STATS[kind, level]
    assert st.get("all_reduce", 0) == 0


def _paged_args(fn, cfg):
    params = _paged(lm, cfg, "paged_chunk").builder.init_params(0)
    rng = np.random.default_rng(3)
    args = []
    for p in fn.parameters:
        t = p.out_types[0]
        if p.name in params:
            args.append(params[p.name])
        elif p.name == "page_tbl":
            args.append(rng.integers(1, SHAPE["n_pages"], size=t.shape)
                        .astype(np.int32))
        elif p.name == "pos":
            args.append(np.full(t.shape, 5, np.int32))
        elif "int" in str(t.dtype):
            args.append(rng.integers(0, 50, size=t.shape).astype(np.int32))
        elif p.name in ("temperature",):
            args.append(np.zeros(t.shape, np.float32))
        else:
            args.append(rng.normal(size=t.shape).astype(t.dtype))
    return args


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_shard_executor_agrees_with_simulate_shards(level):
    """The partitioned paged chunk (f32) through the torch backend's
    shard executor and through the port's ``simulate_shards``: the
    tokens exactly, the logits and the KV pools within 1e-4 of scale."""
    cfg = get_config("deepseek-7b").reduced(compute_dtype="f32")
    fn = _paged(lm, cfg, "paged_chunk").fn
    cf = _cpu().compile(fn, CompileOptions(
        level=level, use_pallas=level == "O2", mode="shardmap",
        partition="tp", mesh_shape=(2,)))
    args = _paged_args(fn, cfg)
    got = cf(*args)
    want = simulate_shards(cf.function, args, {"model": 2})
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
        else:
            scale = max(1.0, float(np.abs(w).max()))
            assert float(np.abs(g - w).max()) <= 1e-4 * scale, i


def test_shard_executor_gathers_exactly():
    """A sharded operand that an op needs whole (Reverse along the
    sharded dim) is gathered, reversed and handed back re-sharded: data
    movement only, so the executor equals ``simulate_shards`` and the
    single-device result bit for bit."""
    x = _param(ops, (4, 16), (None, "ffn"), name="x")
    y = ops.reverse(ops.transpose(x.out(), (1, 0)), axes=(0,))
    fn = Function([x], [y, ops.reverse(x.out(), axes=(1,))])
    cf = _cpu().compile(fn, CompileOptions(
        mode="shardmap", partition="tp", mesh_shape=(2,), level="O0"))
    assert cf.report.stats["partition"]["all_gather"] >= 1
    ins = _inputs(fn)
    want = simulate_shards(cf.function, ins, {"model": 2})
    for g, w, r in zip(cf(*ins), want, _interp(fn, ins)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, r)


# -- the collectives -----------------------------------------------------
def _collectives_fn():
    x = ops.parameter((8, 4), "f32", "x")   # local shard of a (32, 4) array
    return Function([x], [ops.all_reduce(x.out(), "data"),
                          ops.all_gather(x.out(), "data", axis=0,
                                         axis_size=4),
                          ops.reduce_scatter(x.out(), "data", axis=0,
                                             axis_size=4),
                          ops.send_recv(x.out(), "data", shift=1,
                                        axis_size=4),
                          ops.all_to_all(x.out(), "data", 0, 1, 4),
                          ops.all_reduce(x.out(), "data", "max"),
                          ops.all_reduce(x.out(), "data", "min"),
                          ops.all_reduce(x.out(), "data", "mean")])


def test_collectives_over_a_cpu_mesh():
    """The eight-shard (4 x 2) case of ``tests/test_collectives.py``,
    and AllToAll and the other reductions, against numpy over the four
    shards of each data group."""
    cf = _cpu().compile(_collectives_fn(), CompileOptions(
        mode="shardmap", static_jit=False, level="O0"))
    mesh = sharding.make_mesh((4, 2), ("data", "model"),
                              devices=["cpu"] * 8)
    P = ("data", None)
    run = shard_map(cf, mesh, in_specs=[P],
                    out_specs=[(None, None), (None, None), P, P, P,
                               (None, None), (None, None), (None, None)])
    arr = np.arange(128, dtype=np.float32).reshape(32, 4)
    shards = arr.reshape(4, 8, 4)
    ar, ag, rs, pp, a2a, mx, mn, mean = (o.numpy() for o in run(arr))
    np.testing.assert_array_equal(ar, shards.sum(0))
    np.testing.assert_array_equal(ag, arr)
    # reduce-scatter: shard i holds rows [2i, 2i+2) of the sum
    np.testing.assert_array_equal(rs, shards.sum(0))
    # ring shift by 1: shard j holds shard j-1
    np.testing.assert_array_equal(pp, np.roll(shards, 1, 0).reshape(32, 4))
    # all-to-all: shard j gets block j (rows 2j, 2j+1) of every shard,
    # side by side along columns in shard order
    want = np.concatenate([np.concatenate(
        [shards[i][2 * j:2 * j + 2] for i in range(4)], axis=1)
        for j in range(4)])
    np.testing.assert_array_equal(a2a, want)
    np.testing.assert_array_equal(mx, shards.max(0))
    np.testing.assert_array_equal(mn, shards.min(0))
    np.testing.assert_allclose(mean, shards.sum(0) / 4, rtol=1e-6)


def test_collectives_refuse_outside_a_group():
    x = ops.parameter((8, 4), "f32", "x")
    node = ops.all_gather(x.out(), "data", 0, 4).node
    args = [torch.zeros(8, 4)]
    with pytest.raises(RuntimeError, match="requires mode='shardmap'"):
        EMIT["AllGather"](node, args, EmitCtx("cpu"))
    with pytest.raises(RuntimeError, match="inside a shard group"):
        EMIT["AllGather"](node, args, EmitCtx("cpu", mode="shardmap"))
    with pytest.raises(RuntimeError, match="inside a shard group"):
        _cpu().compile(Function([x], [node.out()]), CompileOptions(
            mode="shardmap", level="O0"))(np.zeros((8, 4), np.float32))


def test_collective_types_and_gradients():
    x = ops.parameter((8, 4), "f32", "x")
    assert ops.all_gather(x.out(), "d", 0, 4).shape == (32, 4)
    assert ops.reduce_scatter(x.out(), "d", 0, 4).shape == (2, 4)
    assert ops.all_to_all(x.out(), "d", 0, 1, 4).shape == (2, 16)
    g = grad(Function([x], [ops.reduce_sum(ops.all_reduce(x.out(),
                                                          "data"))]))
    assert g.op_counts()["AllReduce"] == 2
    g2 = grad(Function([x], [ops.reduce_sum(ops.all_gather(
        x.out(), "data", 0, 4))]))
    assert "ReduceScatter" in g2.op_counts()


@pytest.mark.parametrize("compress", [False, True])
def test_shardmap_data_parallel_grad(compress):
    """``tests/test_train_features.py``'s data-parallel pattern: a
    per-shard grad graph whose gradient is AllReduce(mean)'d, optionally
    bf16-compressed by the pass, over eight CPU shards: the global-batch
    gradient (f32 within 1e-5, the bf16 wire within a bf16 unit)."""
    x = ops.parameter((4, 8), "f32", "x")
    w = ops.parameter((8, 8), "f32", "w")
    y = ops.tanh(ops.matmul(x.out(), w.out()))
    loss = ops.reduce_mean(y * y)
    (gw,) = GradBuilder().backprop([loss], [ops.constant(1.0, dtype="f32")],
                                   [w.out()])
    fn = Function([x, w], [loss, ops.all_reduce(gw, "data", "mean")])
    if compress:
        fn, stats = CompressAllReduce(wire_dtype="bf16").run(fn)
        assert stats
    cf = _cpu().compile(fn, CompileOptions(mode="shardmap", level="O0"))
    mesh = sharding.make_mesh((8,), ("data",), devices=["cpu"] * 8)
    run = shard_map(cf, mesh, in_specs=[("data", None), (None, None)],
                    out_specs=[(), (None, None)])
    rng = np.random.default_rng(0)
    X = rng.normal(size=(32, 8)).astype(np.float32)
    W = rng.normal(size=(8, 8)).astype(np.float32)
    g = run(X, W)[1].numpy()
    tx, tw = torch.tensor(X, dtype=torch.float64), \
        torch.tensor(W, dtype=torch.float64, requires_grad=True)
    torch.mean(torch.square(torch.tanh(tx @ tw))).backward()
    ref = tw.grad.numpy()
    tol = 2 ** -7 * np.abs(ref).max() if compress else 1e-5
    assert np.abs(g - ref).max() < tol


# -- the API ------------------------------------------------------------------
def test_profiles_and_policies_equal_the_reference():
    assert sharding.PARTITION_PROFILES == j_sharding.PARTITION_PROFILES
    for name in sharding.PARTITION_PROFILES:
        p, j = sharding.partition_profile(name), \
            j_sharding.partition_profile(name)
        assert (p.name, p.axes, p.rules, p.last_dim_only, p.anywhere) == \
            (j.name, j.axes, j.rules, j.last_dim_only, j.anywhere), name
        assert sharding.policy_for(name if name != "tp" else "default") \
            .as_rules() == j_sharding.policy_for(
                name if name != "tp" else "default").as_rules()
    for bad in ("no-such-profile",):
        with pytest.raises(KeyError):
            sharding.partition_profile(bad)
        with pytest.raises(KeyError):
            sharding.policy_for(bad)
    pol = sharding.policy_for("default")
    assert pol.resolve("ffn") == ("model",) and pol.resolve(None) == ()
    assert isinstance(sharding.policy_for_arch("deepseek-7b"),
                      sharding.ShardingPolicy)


class _FakeMesh:
    axis_names = ("pod", "data", "model")

    class devices:
        shape = (2, 16, 16)


def test_policy_specs_are_tuples():
    """``tests/test_runtime.py``'s policy cases: divisibility, one use of
    a mesh axis per tensor, the arch profiles; the specs are the
    reference's PartitionSpec entries as plain tuples."""
    mesh = _FakeMesh()
    cases = [("default", ("emb", (152064, 8192), ("vocab", "embed"))),
             ("default", ("w", (100, 8192), ("vocab", "embed"))),
             ("default", ("w2", (1024, 1024), ("ffn", "heads"))),
             ("deepseek-v3-671b", ("we", (256, 7168, 2048),
                                   ("experts", "embed", "expert_ffn"))),
             ("mixtral-8x22b", ("we", (8, 6144, 16384),
                                ("experts", "embed", "expert_ffn"))),
             ("deepseek-v3-671b", ("w", (7168, 18432), ("embed", "ffn")))]
    for arch, (name, shape, logical) in cases:
        pol = sharding.policy_for_arch(arch)
        jpol = j_sharding.policy_for_arch(arch)
        spec = pol.spec_for(sharding.ParamInfo(name, shape, None, logical),
                            mesh)
        jspec = jpol.spec_for(j_sharding.ParamInfo(name, shape, None,
                                                   logical), mesh)
        assert isinstance(spec, tuple) and spec == tuple(jspec), arch
    assert sharding.policy_for("default").batch_spec(mesh) == \
        (("pod", "data"), None)


def test_meshes():
    mesh = sharding.make_mesh((1, 2), ("data", "model"),
                              devices=["cpu"] * 2)
    assert mesh.axis_names == ("data", "model")
    assert sharding.mesh_axis_sizes(mesh) == {"data": 1, "model": 2}
    assert sharding.data_axes(mesh) == ("data",)
    assert [str(d) for d in mesh.devices.flat] == ["cpu", "cpu"]
    with pytest.raises(ValueError):
        sharding.make_mesh((2,), ("model",), devices=["cpu"])
    opts = CompileOptions(mode="shardmap", partition="tp", mesh_shape=(2,))
    m = sharding.mesh_for_options(opts, "cpu")
    assert m.axis_names == ("model",) and m.devices.shape == (2,)
    assert sharding.mesh_for_options(CompileOptions()) is None
    explicit = sharding.make_mesh((2,), ("model",), devices=["cpu"] * 2)
    assert sharding.mesh_for_options(
        opts.replace(mesh=explicit), "cpu") is explicit


@pytest.mark.skipif(torch.cuda.device_count() >= 2,
                    reason="the machine has two cards")
def test_mesh_on_too_few_cards_names_the_shared_card_mesh():
    """On CUDA, a mesh of more shards than cards fails fast, naming the
    explicit mesh that puts the shards on one card (the reference names
    its XLA_FLAGS recipe); nothing falls back to the CPU."""
    opts = CompileOptions(mode="shardmap", partition="tp", mesh_shape=(2,))
    with pytest.raises(RuntimeError, match=r"devices=\['cuda:0'\] \* 2"):
        sharding.mesh_for_options(opts, "cuda")
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        sharding.make_mesh((2,), ("model",))


def test_option_messages_equal_the_reference():
    """The partition and mesh_shape checks of ``CompileOptions`` give the
    reference's messages word for word."""
    bad = [dict(partition="nope", mode="shardmap", mesh_shape=(2,)),
           dict(partition="tp", mesh_shape=(2,)),
           dict(partition="tp", mode="shardmap"),
           dict(mesh_shape=(2,)),
           dict(partition="tp", mode="shardmap", mesh_shape=(0,))]
    for kw in bad:
        with pytest.raises(OptionsError) as ours:
            CompileOptions(**kw)
        with pytest.raises(JOptionsError) as ref:
            JOptions(**kw)
        assert str(ours.value) == str(ref.value), kw


def test_stable_token_keeps_tp_apart():
    """The disk cache's key: tp=2 never aliases tp=1, nor an explicit
    mesh of two shards on one device one of two devices."""
    base = CompileOptions(level="O2", use_pallas=True)
    tp2 = base.replace(mode="shardmap", partition="tp", mesh_shape=(2,))
    one = sharding.make_mesh((2,), ("model",), devices=["cpu"] * 2)
    toks = {base.stable_token(), tp2.stable_token(),
            tp2.replace(mesh=one).stable_token()}
    assert None not in toks and len(toks) == 3
    assert tp2.replace(mesh=sharding.make_mesh(
        (2,), ("model",), devices=["cpu"] * 2)).stable_token() == \
        tp2.replace(mesh=one).stable_token()


def test_gather_keeps_one_axis_per_dim_when_table_and_indices_share_it():
    """An embedding gather whose table is cut on its columns and whose
    indices on their rows, both over ``data``: the output keeps the
    indices' cut and gathers the table's columns (the copied rule kept
    the columns cut while typing them whole), and the shards give the
    interpreter's values."""
    table = _param(ops, (8, 4), (None, "embed"), name="table")
    idx = ops.parameter((2, 3), "i32", "idx")
    idx.attrs["logical_axes"] = ("batch", None)
    y = ops.gather(table.out(), idx.out(), axis=0)
    fn = Function([table, idx], [ops.multiply(y, y)])
    pg = PartitionGraph({"embed": "data", "batch": "data"}, {"data": 2})
    part, _ = pg.run(fn)
    assert [p.attrs["pspec"] for p in part.parameters] == \
        [(None, "data"), ("data", None)]
    assert part.results[0].node.attrs["out_pspecs"][0] == \
        ("data", None, None)
    rng = np.random.default_rng(4)
    args = [rng.normal(size=(8, 4)).astype(np.float32),
            rng.integers(0, 8, (2, 3)).astype(np.int32)]
    want = EVAL_FN(fn, args)
    got = simulate_shards(part, args, {"data": 2})
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def test_cse_keeps_iotas_of_different_shapes_apart():
    """Two Iotas over one dim with different shapes are two values: CSE
    keys on out types too (the copied key merged them and failed)."""
    a = ops.iota((2, 3), 0)
    b = ops.iota((4, 3), 0)
    fn = Function([], [a, b])
    out, stats = CSE().run(fn)
    assert [r.shape for r in out.results] == [(2, 3), (4, 3)]
    assert stats["merged"] == 0


def _mlp_args():
    rng = np.random.default_rng(23)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((2, 8), (8, 16), (16, 4))]


def test_pjit_mode_is_refused():
    """mode='pjit' is the partition pass under the policy's profile
    ("default": ffn on model) over the mesh, run by the shard executor:
    on a (2, 2) CPU mesh it gives the jit result, with explicit
    in_shardings (x's rows over data) as with the profile's seeds.  Only
    a mesh that shares no axis with the profile is refused."""
    mesh = sharding.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    x, w1, w2 = _mlp_args()
    want = _cpu().compile(_mlp(), CompileOptions())(x, w1, w2)[0]
    for ins in (None, (("data", None), (None, "model"), ())):
        cf = _cpu().compile(_mlp(), CompileOptions(mode="pjit", mesh=mesh,
                                                   in_shardings=ins))
        specs = [p.attrs["pspec"] for p in cf.function.parameters]
        assert specs[1] == (None, "model")
        assert specs[0] == ((None, None) if ins is None else ("data", None))
        np.testing.assert_allclose(cf(x, w1, w2)[0], want, rtol=1e-5,
                                   atol=1e-6)
    other = sharding.make_mesh((2,), ("x",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="has axes"):
        _cpu().compile(_mlp(), CompileOptions(mode="pjit", mesh=other))
