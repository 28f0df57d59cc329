"""The port's dry run (``repro_torch.launch.dryrun``), its pjit glue and
``mode="pjit"`` against the reference.

- ``_cell`` on reduced configs over a ``(2, 2)`` meta mesh writes a
  record with the reference's keys (plus the pass's stats), and its
  ``ir_flops_global`` / ``ir_bytes_global`` equal the reference's
  ``function_cost`` on the reference's graph of the same cell.
- The glue's specs equal the reference's ``PartitionSpec``\\ s, compared
  as tuples on a one-device host mesh; the production meshes have the
  reference's device counts.
- ``mode="pjit"`` on a ``(2, 2)`` CPU mesh gives the port's ``jit``
  result and JAX's ``jit`` of the reference graph: argmax identical, f32
  within 1e-4 of scale.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.backend import Backend as JBackend  # noqa: E402
from repro.backend import CompileOptions as JOptions  # noqa: E402
from repro.backend import sharding as j_sharding  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.core.cost import function_cost as j_function_cost  # noqa: E402
from repro.launch import roofline as jr  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models.train_graph import make_train_step as j_train  # noqa: E402

from repro_torch.backend import Backend, CompileOptions  # noqa: E402
from repro_torch.backend import sharding  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.train_graph import make_train_step  # noqa: E402

# reduced cells: the published shapes cut to a small sequence and batch
SMALL = {"train_4k": (32, 8), "prefill_32k": (64, 4), "decode_32k": (64, 8),
         "long_500k": (64, 2)}
EXTRA_KEYS = ("collective_bytes_as_compiled", "n_params", "graph_nodes",
              "lower_s", "compile_s", "attn_impl", "n_micro",
              "hlo_collective_lines")


def _small(shapes, name):
    seq, batch = SMALL[name]
    return dataclasses.replace(shapes[name], seq_len=seq, global_batch=batch)


def _reference_keys():
    rl = jr.Roofline(arch="a", shape="s", mesh="m", n_devices=1,
                     hlo_flops=1.0, hlo_bytes=1.0, ir_flops=1.0,
                     ir_bytes=1.0, collective_bytes=0.0, model_flops=1.0,
                     collectives={}, coll_bytes_by_kind={},
                     per_device_memory=0.0)
    return set(rl.to_dict()) | set(EXTRA_KEYS)


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-7b", "train_4k"), ("deepseek-7b", "decode_32k"),
    ("mixtral-8x22b", "prefill_32k"), ("xlstm-350m", "long_500k")])
def test_cell_on_a_meta_mesh_writes_the_reference_record(
        tmp_path, monkeypatch, arch, shape):
    """A reduced cell over a (2, 2) meta mesh: compiled with
    mode='pjit', walked on meta tensors to outputs of the IR's shapes,
    recorded with the reference's keys and the pass's stats; its IR
    cost is the reference's function_cost of the reference's graph."""
    cfg = get_config(arch).reduced()
    mesh = sharding.make_mesh((2, 2), ("data", "model"),
                              devices=["meta"] * 4)
    monkeypatch.setitem(SHAPES, shape, _small(SHAPES, shape))
    rec = dryrun._cell(arch, shape, False, out_dir=str(tmp_path),
                       cfg=cfg, mesh=mesh, force=True)
    assert _reference_keys() <= set(rec)
    path = os.path.join(tmp_path, "2x2", f"{arch}__{shape}.json")
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert rec["n_devices"] == 4 and rec["mesh"] == "2x2"
    assert rec["partition"]["params_total"] > 0
    assert rec["t_compute_s"] > 0 and rec["t_memory_s"] > 0
    assert rec["per_device_memory_bytes"] > 0
    assert rec["memory_plan"]["scan_body_temporaries"] == "not counted"
    # the reference's cost model on the reference's graph of the cell
    jcfg = j_get_config(arch).reduced()
    js = _small(J_SHAPES, shape)
    jg = j_lm.build_graphs(jcfg, js, js.global_batch)
    jfn = j_train(jg, jcfg).fn if js.kind == "train" else jg.fn
    want = j_function_cost(jfn, attn_impl="chunked")
    assert (rec["ir_flops_global"], rec["ir_bytes_global"]) == \
        (want.flops, want.bytes)
    assert rec["model_flops"] == jr.model_flops_for(
        jg.builder, jcfg, js.kind, js.seq_len, js.global_batch)


def test_full_width_cell_on_the_production_mesh(tmp_path, capsys):
    """xlstm-350m x decode_32k at published widths on the 256-device meta
    mesh, through main(): green, with the reference's record."""
    assert dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                        "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[ok] hgx32x8 xlstm-350m__decode_32k:" in out
    assert out.rstrip().endswith("DRY-RUN GREEN")
    path = os.path.join(tmp_path, "hgx32x8", "xlstm-350m__decode_32k.json")
    with open(path) as f:
        rec = json.load(f)
    assert _reference_keys() <= set(rec) and rec["n_devices"] == 256
    assert rec["pass_mesh"] == {"data": 32, "model": 8}


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-v3-671b"])
def test_full_width_train_cells_that_met_the_pass_faults(arch):
    """Two full-width train cells on the production mesh that the copied
    passes failed: recurrentgemma-9b's, where a backward floor outlived
    the input specs that allowed it (an Add of 512 and 4096 columns on
    the walk; the pass now vetoes such floors and infers again), and
    deepseek-v3-671b's, where CSE merged Iotas of two shapes (its key
    now holds the out types)."""
    rec = dryrun._cell(arch, "train_4k", False, save=False)
    assert rec["n_devices"] == 256 and rec["partition"]["params_sharded"]
    assert rec["fallback_gathers"].get("SoftmaxCrossEntropy")


def test_pjit_glue_specs_equal_the_reference():
    """graph_shardings and train_step_shardings on a one-device host
    mesh: every spec the reference's PartitionSpec as a tuple, the same
    donation and axis rules; the production meshes' shapes and names."""
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    mesh = sharding.make_host_mesh(devices=["cpu"])
    assert mesh.devices.shape == (1, 1)
    for arch in ("deepseek-7b", "deepseek-v3-671b"):
        cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
        s, js = _small(SHAPES, "train_4k"), _small(J_SHAPES, "train_4k")
        g, jg = lm.build_graphs(cfg, s, 8), j_lm.build_graphs(jcfg, js, 8)
        ins, rules = sharding.graph_shardings(g, mesh)
        jins, jrules = j_sharding.graph_shardings(jg, jmesh)
        assert list(ins) == [tuple(x.spec) for x in jins]
        assert rules == jrules
        got = sharding.train_step_shardings(make_train_step(g, cfg), mesh)
        want = j_sharding.train_step_shardings(j_train(jg, jcfg), jmesh)
        assert [list(x) for x in got[:2]] == \
            [[tuple(y.spec) for y in x] for x in want[:2]]
        assert got[2:] == want[2:]
    for mp, shape, name in ((False, (32, 8), "hgx32x8"),
                            (True, (2, 32, 8), "hgx2x32x8")):
        m = sharding.make_production_mesh(multi_pod=mp)
        assert m.devices.shape == shape
        assert m.devices.size == 256 * (1 + mp)
        assert sharding.is_meta(m) and \
            sharding.production_mesh_name(mp) == name
        folded = sharding.fold_pods(m)
        assert sharding.mesh_axis_sizes(folded) == {"data": 32 * (1 + mp),
                                                    "model": 8}


def test_pass_spec_folds_pods_and_refuses_what_it_cannot_cut():
    sizes = {"data": 64, "model": 8}
    assert sharding.pass_spec((("pod", "data"), None), (128, 4), sizes) == \
        ("data", None)
    assert sharding.pass_spec((("data", "model"),), (512,), sizes) == \
        ("data",)
    assert sharding.pass_spec((), (4, 4), sizes) == (None, None)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.pass_spec(("data",), (96,), sizes)
    with pytest.raises(ValueError, match="mesh has axes"):
        sharding.pass_spec(("expert",), (96,), sizes)


def _inputs(types, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for t in types:
        if np.issubdtype(t.dtype, np.integer):
            out.append(rng.integers(0, 8, t.shape).astype(t.dtype))
        else:
            out.append((rng.standard_normal(t.shape) * 0.1).astype(t.dtype))
    return out


def test_pjit_on_a_cpu_mesh_equals_jit_and_the_reference():
    """Reduced deepseek-7b's decode graph in f32 with the glue's specs
    (batch over data, ZeRO dims over data, ffn and heads over model) on
    a (2, 2) CPU mesh: the port's pjit gives its jit result and JAX's jit
    of the reference graph, argmax identical, f32 within 1e-4 of scale;
    the caches' updated rows too."""
    arch = "deepseek-7b"
    cfg = get_config(arch).reduced(compute_dtype="f32")
    jcfg = j_get_config(arch).reduced(compute_dtype="f32")
    s, js = _small(SHAPES, "decode_32k"), _small(J_SHAPES, "decode_32k")
    g, jg = lm.build_graphs(cfg, s, 8), j_lm.build_graphs(jcfg, js, 8)
    mesh = sharding.make_mesh((2, 2), ("data", "model"),
                              devices=["cpu"] * 4)
    ins, rules = sharding.graph_shardings(g, mesh)
    be = Backend.create("torch", device="cpu")
    cf = be.compile(g.fn, CompileOptions(
        mode="pjit", mesh=mesh, in_shardings=ins, axis_rules=rules,
        partition=sharding.profile_for_arch(arch)))
    st = cf.report.stats["partition"]
    assert st["params_sharded"] > 0 and st["all_gather"] > 0
    args = _inputs(g.fn.in_types)
    got = cf(*args)
    jit = be.compile(g.fn, CompileOptions())(*args)
    ref = [np.asarray(o) for o in
           JBackend.create("jax").compile(jg.fn, JOptions())(*args)]
    assert len(got) == len(jit) == len(ref)
    for a, b, c in zip(got, jit, ref):
        assert a.shape == b.shape == c.shape and a.dtype == b.dtype
        scale = max(float(np.abs(c).max()), 1.0)
        assert np.abs(a - b).max() <= 1e-4 * scale
        assert np.abs(a - c).max() <= 1e-4 * scale
    logits = got[0]
    assert (logits.argmax(-1) == jit[0].argmax(-1)).all()
    assert (logits.argmax(-1) == ref[0].argmax(-1)).all()
