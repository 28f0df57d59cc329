"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's formulas and against bytes counted by hand.

- The collective census reads the partitioned IR: a tp=2 MLP's gather
  and a row-parallel MLP's AllReduce carry the reference's ring factors
  on their result bytes; a collective inside a nested Scan counts once
  per trip of both loops (the reference's
  ``test_collective_parser_scales_while_bodies``, on IR).
- ``Roofline``'s properties and ``to_dict`` equal the reference's on the
  same inputs, with the reference module's constants set to the H100's
  inside the test (no file edited); ``model_flops_for`` equals the
  reference's on the same reduced dense and MoE builders, exactly.
- Each mesh axis takes its own link: ``model`` NVLink, ``data`` the
  node's network.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.launch import roofline as jr  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.function import Function  # noqa: E402
from repro_torch.core.passes import PartitionGraph  # noqa: E402
from repro_torch.launch import roofline as tr  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def _mlp():
    x = ops.parameter((2, 8), "f32", "x")
    w1 = ops.parameter((8, 16), "f32", "w1")
    w1.attrs["logical_axes"] = (None, "ffn")
    w2 = ops.parameter((16, 4), "f32", "w2")
    w2.attrs["logical_axes"] = ("ffn", None)
    y = ops.matmul(ops.relu(ops.matmul(x.out(), w1.out())), w2.out())
    return Function([x, w1, w2], [y])


@pytest.mark.parametrize("last_dim_only", [True, False],
                         ids=["tp_gather", "row_parallel"])
def test_census_of_tp2_mlp_equals_ring_bytes_by_hand(last_dim_only):
    """tp (last dim only): the hidden (2, 16) f32 activation is gathered
    over 2 shards, 128 bytes x 1/2 on the wire.  Row-parallel: w2 is cut
    on its rows and the (2, 4) f32 product all-reduced, 2 x 32 bytes x
    1/2."""
    pg = PartitionGraph({"ffn": "model"}, {"model": 2},
                        last_dim_only=last_dim_only)
    fn, _ = pg.run(_mlp())
    census = tr.census_collectives(fn, {"model": 2})
    kind, wire = (("all-gather", 2 * 16 * 4 * 0.5) if last_dim_only
                  else ("all-reduce", 2.0 * 2 * 4 * 4 * 0.5))
    assert census.counts == {kind: 1} and census.nodes == {kind: 1}
    assert census.bytes_by_kind == {kind: wire}
    assert census.total_bytes == census.total_tpu_bytes == wire
    assert census.bytes_by_axis == {"model": wire}


def test_collective_census_scales_nested_scan_bodies():
    """A gather inside a 4-trip Scan inside a 3-trip Scan counts 12
    times; the one node once."""
    c = ops.parameter((2, 4), "f32", "c")
    inner = Function([c], [c.out(), ops.all_gather(c.out(), "model", 0, 2)])
    c2 = ops.parameter((2, 4), "f32", "c2")
    carry, ys = ops.scan(inner, [c2.out()], length=4)
    outer = Function([c2], [carry, ys])
    x = ops.parameter((2, 4), "f32", "x")
    carry, yss = ops.scan(outer, [x.out()], length=3)
    fn = Function([x], [carry, yss])
    census = tr.census_collectives(fn, {"model": 2})
    wire = 4 * 4 * 4 * 0.5      # the (4, 4) f32 result, ring 1/2
    assert census.counts == {"all-gather": 12}
    assert census.nodes == {"all-gather": 1}
    assert census.bytes_by_kind == {"all-gather": 12 * wire}
    # a group of one moves nothing
    assert tr.census_collectives(fn, {"model": 1}).total_bytes == 0.0


def test_each_axis_takes_its_own_link():
    """A gather over ``data`` crosses the node's network (50 GB/s), one
    over ``model`` NVLink (450 GB/s); the roofline's collective term is
    their sum, where one link for both would misstate either."""
    x = ops.parameter((4, 8), "f32", "x")
    a = ops.all_gather(x.out(), "data", 0, 4)
    b = ops.all_gather(x.out(), "model", 1, 2)
    fn = Function([x], [a, b])
    census = tr.census_collectives(fn, {"data": 4, "model": 2})
    data = 16 * 8 * 4 * 0.75
    model = 4 * 16 * 4 * 0.5
    assert census.bytes_by_axis == {"data": data, "model": model}
    assert tr.LINK_BW["data"] == tr.LINK_BW["pod"] == tr.NIC_BW == 50e9
    assert tr.LINK_BW["model"] == tr.NVLINK_BW == 450e9
    want = data / 50e9 + model / 450e9
    rl = _roofline(tr, collective_bytes=census.total_bytes,
                   coll_bytes_by_axis=census.bytes_by_axis)
    assert rl.t_collective == pytest.approx(want, rel=1e-15)
    assert census.total_bytes / 450e9 < rl.t_collective < \
        census.total_bytes / 50e9


def _roofline(mod, **kw):
    args = dict(arch="a", shape="s", mesh="m", n_devices=256,
                hlo_flops=3.0e12, hlo_bytes=7.0e9, ir_flops=6.4e15,
                ir_bytes=1.9e13, collective_bytes=4.5e9, model_flops=5.1e15,
                collectives={"all-gather": 3},
                coll_bytes_by_kind={"all-gather": 4.5e9},
                per_device_memory=2.0e10)
    args.update(kw)
    return mod.Roofline(**args)


@pytest.mark.parametrize("case", [
    {}, {"collective_bytes": 4.5e13}, {"ir_flops": 6.4e18},
    {"n_devices": 1, "collective_bytes": 0.0}, {"ir_flops": 0.0}],
    ids=["memory", "collective", "compute", "one_device", "no_flops"])
def test_roofline_properties_equal_the_reference(monkeypatch, case):
    """The reference's formulas with its constants set to the H100's
    (its one link to the model axis's NVLink): every property and the
    whole ``to_dict`` agree."""
    monkeypatch.setattr(jr, "PEAK_FLOPS", tr.PEAK_FLOPS)
    monkeypatch.setattr(jr, "HBM_BW", tr.HBM_BW)
    monkeypatch.setattr(jr, "LINK_BW", tr.LINK_BW["model"])
    ours, ref = _roofline(tr, **case), _roofline(jr, **case)
    for prop in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "useful_flops_ratio", "roofline_fraction"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    assert ours.to_dict() == ref.to_dict()
    assert (tr.PEAK_FLOPS, tr.HBM_BW) == (989e12, 3.35e12)


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-7b", "train_4k"), ("deepseek-7b", "decode_32k"),
    ("mixtral-8x22b", "prefill_32k"), ("deepseek-v3-671b", "train_4k")])
def test_model_flops_for_equals_the_reference(arch, shape):
    """The same reduced builders (dense and MoE, routed experts scaled
    by top_k / E) give the reference's MODEL_FLOPS exactly."""
    small = dataclasses.replace(SHAPES[shape], seq_len=64, global_batch=2)
    jsmall = dataclasses.replace(J_SHAPES[shape], seq_len=64, global_batch=2)
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    g = lm.build_graphs(cfg, small, 2)
    jg = j_lm.build_graphs(jcfg, jsmall, 2)
    for kind, seq, batch in ((small.kind, 64, 2), ("train", 512, 4),
                             ("decode", 1, 16)):
        got = tr.model_flops_for(g.builder, cfg, kind, seq, batch)
        want = jr.model_flops_for(jg.builder, jcfg, kind, seq, batch)
        assert got == want and got > 0, (kind, got, want)
    if cfg.n_experts:
        n = sum(s.size for s in g.builder.params.values())
        assert tr.model_flops_for(g.builder, cfg, "decode", 1, 1) < 2 * n


def test_no_tpu_figure_in_the_module():
    """The reference's TPU v5e constants are gone from the port's."""
    src = open(tr.__file__).read()
    for fig in ("197e12", "819e9", "v5e"):
        assert fig not in src
