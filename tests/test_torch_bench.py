"""The port's benchmark harness (``scripts/torch_bench.py``) and its
snapshot check (``scripts/torch_bench_to_json.py``) on the CPU.

The IR-only and structural sections give the reference's rows
(``benchmarks/run.py`` on JAX) at the same shapes; one reduced run of all
18 sections writes a snapshot the check passes; hand-edited snapshots,
a card snapshot with no kernel launch or with a refusal among them, fail
with a readable ``CHECK FAIL`` line."""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "scripts", "torch_bench.py")
SNAP = os.path.join(REPO, "scripts", "torch_bench_to_json.py")

# the reference's row -> the port's (the port has no XLA, no jax.grad and
# no Pallas interpret mode)
RENAMED = {
    "ir_grad_vs_jax_grad_max_abs_diff":
        "ir_grad_vs_torch_autograd_max_abs_diff",
    "pallas_flash_vs_oracle_max_abs_diff":
        "flash_kernel_vs_oracle_max_abs_diff",
}
FLOAT_TOL = 1e-4   # the *_max_abs_diff rows, port against reference


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    mod = _load(BENCH, "torch_bench_under_test")
    mod.configure("cpu", reduced=True)
    return mod


def _rows(rows):
    return {(r["section"], r["name"]): (r["value"], r["unit"]) for r in rows}


@pytest.mark.parametrize("section", ["memory", "layout", "collectives",
                                     "autodiff", "compounding"])
def test_structural_rows_equal_the_reference(bench, section, capsys):
    """Node counts, fused counts, bytes, census and collective counts are
    the reference's exactly; the float rows agree within 1e-4."""
    sys.path.insert(0, REPO)
    from benchmarks import run as ref

    ref.ROWS.clear()
    ref.SECTIONS[section]()
    want = _rows(ref.ROWS)
    bench.ROWS.clear()
    bench.SECTIONS[section]()
    got = _rows(bench.ROWS)
    capsys.readouterr()
    assert want, section
    for (sec, name), (value, unit) in want.items():
        key = (sec, RENAMED.get(name, name))
        assert key in got, f"{key} missing; the port has {sorted(got)}"
        gv, gu = got[key]
        assert gu == unit, (key, gu, unit)
        if name.endswith("_max_abs_diff"):
            assert abs(float(gv) - float(value)) <= FLOAT_TOL, (key, gv, value)
        else:
            assert gv == value, (key, gv, value)
    extra = set(got) - {(s, RENAMED.get(n, n)) for s, n in want}
    assert not extra, f"rows the reference does not emit: {sorted(extra)}"


def test_reduced_cpu_snapshot_of_all_sections_passes_check(bench, tmp_path):
    """All 18 sections once at the reduced config on the CPU: the
    snapshot records the device, the model and each section's seconds,
    every parity row is 1, and the check passes it."""
    out = tmp_path / "bench.json"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, SNAP, "--device", "cpu", "--reduced", "--sections",
         *bench.SECTIONS, "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and doc["sections"] == list(bench.SECTIONS)
    assert doc["model"]["reduced"] is True
    assert set(doc["section_stats"]) == set(bench.SECTIONS)
    rows = _rows(doc["rows"])
    parity = [k for k in rows if ("matches" in k[1] or "parity" in k[1])
              and not k[1].endswith("_bf16")]
    assert len(parity) >= 8, parity
    assert all(rows[k][0] == "1" for k in parity), \
        {k: rows[k][0] for k in parity}
    assert rows[("E17_partition", "tp2_one_card")][0] == "1"
    assert rows[("E14_kernels", "matmul_refused_ok")][0] == "1"
    r = subprocess.run([sys.executable, SNAP, "--check", str(out)],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr


def test_harness_refuses_a_missing_card():
    """Without ``--device cpu`` the harness needs a card: it exits
    non-zero before any section runs, never carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the CPU-only refusal cannot show")
    r = subprocess.run([sys.executable, BENCH, "memory"],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr and "E4_memory" not in r.stdout


def _check(*argv):
    return subprocess.run([sys.executable, SNAP, *argv],
                          capture_output=True, text=True, cwd=REPO)


def _doc(section, label, rows, device="cpu"):
    return {"schema_version": 1, "sections": [section], "device": device,
            "rows": [{"section": label, "name": n, "value": str(v),
                      "unit": ""} for n, v in rows]}


def _kernel_rows(launches=1, rejected=0):
    return [(f"launches_{k}", launches) for k in
            ("matmul", "norm_matmul", "swiglu", "rmsnorm",
             "flash_attention")] + \
        [("rejected_matmul", rejected)]


_PAGED = [("paged_tok_s", 5), ("paged_decode_tok_s", 5),
          ("paged_kv_bytes_per_active_token", 600),
          ("continuous_kv_bytes_per_active_token", 900),
          ("paged_kv_bytes_ratio", 0.66), ("paged_matches_continuous", 1),
          ("paged_ttft_p95_ms", 3)]
_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _with(rows, **over):
    return [(n, over.get(n, v)) for n, v in rows]


@pytest.mark.parametrize("doc, expect", [
    ({"schema_version": 1, "device": "cpu"}, "missing top-level keys"),
    ({k: v for k, v in _doc("paged", "E12_paged", _PAGED).items()
      if k != "device"}, "missing top-level keys ['device']"),
    ({"schema_version": 1, "sections": ["serving"], "device": "cpu",
      "rows": [{"section": "E10_serving", "name": "lockstep_tok_s",
                "value": "5"}]}, "missing keys ['unit']"),
    ({"schema_version": 1, "sections": ["serving"], "device": "cpu",
      "rows": [["not", "a", "dict"]]}, "rows[0] must be an object"),
    (_doc("serving", "E10_serving", [("lockstep_tok_s", "oops")]),
     "not numeric"),
    (_doc("paged", "E12_paged", _PAGED[:1]),
     "paged row missing: 'paged_kv_bytes_per_active_token'"),
    (_doc("paged", "E12_paged", _with(_PAGED, paged_kv_bytes_ratio=1.5)),
     "paged_kv_bytes_ratio must be < 1"),
    (_doc("paged", "E12_paged", _with(_PAGED, paged_matches_continuous=2)),
     "paged row paged_matches_continuous must be 1"),
    (_doc("paged", "E12_paged", _PAGED + _kernel_rows(launches=0),
          device=_CARD), "E12_paged: no kernel launched on the card"),
    (_doc("paged", "E12_paged", _PAGED + _kernel_rows(rejected=3),
          device=_CARD), "E12_paged row rejected_matmul must be 0"),
    (_doc("compounding", "E6_compound", [("nodes_fused", 29)],
          device=_CARD), "'flash_launches'"),
    (_doc("kernels", "E14_kernels", [("swiglu_decode_selected_over_unfused",
                                      1.2)]),
     "swiglu_decode_selected_over_unfused must be <= 1"),
    (_doc("kernels", "E14_kernels", [("matmul_refused_ok", 0)]),
     "kernels row matmul_refused_ok must be 1"),
    (_doc("prefix", "E16_prefix", [("prefix_kv_bytes_ratio", 0.7)]),
     "prefix_kv_bytes_ratio must be <= 0.6"),
    (_doc("partition", "E17_partition", [("tp2_matches_tp1", 0),
                                         ("kv_bytes_per_device_ratio", 1)]),
     "partition row tp2_matches_tp1 must be 1"),
    (_doc("server", "E13_server", [("server_clients", 2),
                                   ("server_slots", 2)]),
     "must over-subscribe the engine"),
])
def test_edited_snapshot_fails_with_readable_diff(tmp_path, doc, expect):
    path = tmp_path / "edited.json"
    path.write_text(json.dumps(doc))
    r = _check("--check", str(path))
    assert r.returncode == 1
    assert "Traceback" not in r.stderr
    assert "CHECK FAIL" in r.stderr
    assert expect in r.stderr


def test_card_snapshot_with_launches_passes(tmp_path):
    """The card-only gates pass a section that launched and refused
    nothing, and E6 with its flash launch."""
    doc = _doc("paged", "E12_paged", _PAGED + _kernel_rows(), device=_CARD)
    doc["sections"].append("compounding")
    doc["rows"].append({"section": "E6_compound", "name": "flash_launches",
                        "value": "1", "unit": "launches"})
    path = tmp_path / "card.json"
    path.write_text(json.dumps(doc))
    r = _check("--check", str(path))
    assert r.returncode == 0, r.stderr


def test_unparseable_snapshot_fails_readably(tmp_path):
    path = tmp_path / "torn.json"
    path.write_text('{"schema_version": 1,')
    r = _check("--check", str(path))
    assert r.returncode == 1
    assert "Traceback" not in r.stderr
    assert "not valid JSON" in r.stderr


def test_autotune_dir_validation(tmp_path):
    """Records are held to the port's own schema."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.backend import autotune
    cand = {k: False for k in autotune.RECORD_FIELDS}
    cand.update(attn_impl="auto", attn_chunk=1024, mm_bm=None, mm_bn=None,
                mm_bk=None)
    good = {"format": 1, "schema": autotune.SCHEMA, "backend": "torch",
            "signature": "x", "versions": {"torch": "0"},
            "candidates": [dict(cand, ms=1.0)], "winner": dict(cand)}
    assert autotune.validate_record(good) == []
    tdir = tmp_path / "autotune"
    tdir.mkdir()
    (tdir / "a.tune.json").write_text(json.dumps(good))
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps(_doc("paged", "E12_paged", _PAGED)))
    r = _check("--check", str(snap), "--autotune-dir", str(tdir))
    assert r.returncode == 0, r.stderr
    bad = dict(good)
    bad.pop("winner")
    (tdir / "b.tune.json").write_text(json.dumps(bad))
    r = _check("--check", str(snap), "--autotune-dir", str(tdir))
    assert r.returncode == 1
    assert "missing key 'winner'" in r.stderr
