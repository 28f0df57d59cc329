"""The serving matrix on torch (``scripts/torch_serving_matrix.py``),
judged by the reference's unchanged ``scripts/check_serving_matrix.py``.

On the CPU at reduced width with the reference CI's workloads:

  * the serve CLI's ``--tp 2`` report carries ``workload.tp == 2``, which
    the checker's paged-tp2 gate reads;
  * ``run_matrix`` writes the eight legs' reports and the checker
    passes them, in process and as its own process; the engine legs'
    tokens are those of ``serve.main`` called with the CI's flags alone;
  * a report with a leaked page, a tp leg without its ``tp``, a shared
    pair without a copy-on-write or a server that did not drain makes
    the checker fail: it reads the port's keys;
  * at the CI's seed 0 the donated and continuous legs split one greedy
    token, and only at a tie: the port's top two logits there are one
    bf16 unit apart and are the two legs' picks (the reason the matrix
    runs at ``MATRIX_SEED``).
"""
import copy
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mx = _load("torch_serving_matrix")
checker = _load("check_serving_matrix")
ENGINE_LEGS = [leg for leg in mx.LEGS if leg not in ("server", "chaos")]


def _cli(leg, path, seed):
    """``python -m repro_torch.launch.serve`` with the CI's flags."""
    argv = ["--arch", "deepseek-7b", "--reduced",
            *mx.CI_WORKLOAD[leg].split(), "--seed", str(seed),
            "--device", "cpu", "--report-json", str(path)]
    assert serve.main(argv) == 0
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    out = tmp_path_factory.mktemp("matrix")
    legs = mx.run_matrix(get_config("deepseek-7b").reduced(), "cpu",
                         str(out), reduced=True)
    docs = {}
    for leg, info in legs.items():
        with open(info["path"]) as f:
            docs[leg] = json.load(f)
    return legs, docs


def test_tp2_report_carries_the_workload_tp(tmp_path):
    doc = _cli("paged-tp2", tmp_path / "tp2.json", 0)
    assert doc["leg"] == "paged-tp2"
    assert doc["tp"] == 2 and doc["workload"]["tp"] == 2
    assert doc["kv_bytes_per_device"] * 2 == doc["pool"]["total_bytes"]


def test_run_matrix_reports_pass_the_unchanged_checker(matrix, capsys):
    legs, docs = matrix
    assert list(legs) == list(mx.LEGS)
    paths = [info["path"] for info in legs.values()]
    assert [os.path.basename(p) for p in paths] == \
        [f"engine-report-{leg}.json" for leg in mx.LEGS]
    assert checker.check(paths) == 0
    assert "serving matrix ok" in capsys.readouterr().out
    proc = mx.check_reports(paths)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("serving matrix ok")
    # every engine report is the CLI's shape, with the run's counts
    for leg in ENGINE_LEGS:
        doc = docs[leg]
        assert doc["device"] == "cpu" and set(doc["kernels"]) == {
            "matmul", "norm_matmul", "swiglu", "rmsnorm", "flash_attention",
            "batched_matmul"}
        assert doc["workload"]["seed"] == mx.MATRIX_SEED
    assert docs["server"]["results"].keys() == {"0", "1", "2"}
    assert docs["server"]["drain_ok"] is True
    assert all(s["ok"] for s in docs["chaos"]["scenarios"].values())


def test_engine_legs_equal_the_cli_called_as_ci_does(matrix, tmp_path,
                                                     capsys):
    legs, docs = matrix
    paths = []
    for leg in ENGINE_LEGS:
        doc = _cli(leg, tmp_path / f"engine-report-{leg}.json",
                   mx.MATRIX_SEED)
        assert doc["results"] == docs[leg]["results"], leg
        assert doc["workload"] == docs[leg]["workload"], leg
        paths.append(str(tmp_path / f"engine-report-{leg}.json"))
    paths += [legs["server"]["path"], legs["chaos"]["path"]]
    assert checker.check(paths) == 0, capsys.readouterr().err


def _set(doc, keys, value):
    for k in keys[:-1]:
        doc = doc[k]
    if value is None:
        del doc[keys[-1]]
    else:
        doc[keys[-1]] = value


@pytest.mark.parametrize("leg,keys,value,message", [
    ("paged", ("pool", "pages_in_use"), 1,
     "paged: 1 pages still in use after the workload drained (leak)"),
    ("paged", ("pool", "page_frees"), 0, "paged: page_allocs"),
    ("paged-tp2", ("workload", "tp"), None,
     "paged-tp2: report tp=2 / workload tp=None"),
    ("paged-shared-prefix", ("pool", "cow_copies"), 0,
     "shared-prefix: cow_copies = 0"),
    ("server", ("drain_ok",), False, "server: drain_ok is not true"),
])
def test_checker_fails_a_broken_report(matrix, tmp_path, capsys, leg, keys,
                                       value, message):
    legs, docs = matrix
    paths = []
    for name, info in legs.items():
        doc = copy.deepcopy(docs[name])
        if name == leg:
            _set(doc, keys, value)
        path = tmp_path / os.path.basename(info["path"])
        path.write_text(json.dumps(doc))
        paths.append(str(path))
    assert checker.check(paths) == 1
    err = capsys.readouterr().err
    assert f"MATRIX FAIL: {message}" in err, err


def _ulp(x: float) -> float:
    """One bf16 unit in the last place at the magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(x)), 2.0 ** -14))) - 7)


def test_seed0_donated_continuous_split_is_a_tie(tmp_path, capsys):
    from repro_torch.backend import Backend
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs

    cfg = get_config("deepseek-7b").reduced()
    don = _cli("donated", tmp_path / "engine-report-donated.json", 0)
    con = _cli("continuous", tmp_path / "engine-report-continuous.json", 0)
    assert checker.check([str(tmp_path / "engine-report-donated.json"),
                          str(tmp_path / "engine-report-continuous.json")
                          ]) == 1
    fails = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("MATRIX FAIL")]
    split = [ln for ln in fails if "diverged from continuous" in ln]
    assert split and len(split) == sum("donated: req" in ln for ln in fails)
    params = serve.full_width_builder(cfg, 16, 3).init_params(0)
    prompts = serve.workload_prompts(cfg, 3, 4, 0, 0)
    witnessed = 0
    for rid, dt in don["results"].items():
        ct = con["results"][rid]
        differ = [i for i, (a, b) in enumerate(zip(dt, ct)) if a != b]
        if not differ:
            continue
        j = differ[0]
        seq = np.concatenate([prompts[int(rid)], np.asarray(dt[:j])])
        g = build_graphs(cfg, ShapeConfig("prefill", "prefill", len(seq), 1),
                         1)
        cf = Backend.create("torch", device="cpu").compile(g.fn)
        lg = np.asarray(cf(seq.astype(np.int32)[None], *[
            params[n] for n in g.builder.param_names()])[0],
            np.float32).reshape(-1)
        a, b = (int(t) for t in np.argsort(-lg, kind="stable")[:2])
        assert {a, b} == {dt[j], ct[j]}, (rid, j, a, b)
        assert lg[a] - lg[b] <= _ulp(lg[a]), (rid, j, lg[a], lg[b])
        witnessed += 1
    assert witnessed == len(split)
