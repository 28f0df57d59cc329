"""The port's tooling on the CPU: the buffer probe
(``scripts/torch_probe_buffers.py``), the tables
(``scripts/torch_make_tables.py``), the every-arch smoke
(``scripts/torch_smoke_all.py``) and the first two examples
(``examples/torch_quickstart.py``, ``examples/torch_bridge_demo.py``),
each run without jax or the reference imported."""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = ("xlstm-350m", "decode_32k")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_buffers_prints_the_plan_and_the_largest_values(capsys):
    out = _script("torch_probe_buffers").probe(*CELL)
    text = capsys.readouterr().out
    first = text.splitlines()[0]
    assert first.startswith("temp=") and " args=" in first and \
        " out=" in first and "Scan-body temporaries are not in the plan" \
        in first
    assert out["plan"].peak_live_bytes > 0
    top = out["top"]
    assert len(top) == 25 and all(b > 0 for (_, _), (_, b) in top)
    assert [b for _, (_, b) in top] == sorted(
        (b for _, (_, b) in top), reverse=True)
    # the Scan bodies are walked: a value only a body holds is listed
    ops = {op for (op, _), _ in top}
    assert "Scan" in ops and "AllGather" in ops
    assert "largest per-shard values of the partitioned IR" in text


def test_tables_render_one_dry_run_cell(tmp_path, capsys):
    from repro_torch.launch.dryrun import _cell
    rec = _cell(*CELL, False, out_dir=str(tmp_path), force=True)
    tables = _script("torch_make_tables")
    capsys.readouterr()
    assert tables.main(["roofline", "--out-dir", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "### Roofline — hgx32x8 (256 H100s)" in text
    row = [ln for ln in text.splitlines() if ln.startswith("| xlstm-350m")]
    assert len(row) == 1 and f"| {rec['bottleneck']} |" in row[0]
    assert f"**{rec['roofline_fraction']:.3g}**" in row[0]
    assert tables.main(["dryrun", "--out-dir", str(tmp_path)]) == 0
    assert "### Dry-run — hgx2x32x8" in capsys.readouterr().out
    # a record without a key prints n/a; a run without the cell, n/a
    part = tmp_path / "part"
    part.mkdir()
    del rec["t_memory_s"]
    (part / "xlstm-350m__decode_32k.json").write_text(json.dumps(rec))
    assert tables.main(["perf", "__".join(CELL),
                        f"full={tmp_path}", f"part={part}",
                        f"none={tmp_path / 'absent'}"]) == 0
    rows = {ln.split("|")[1].strip(): ln for ln in
            capsys.readouterr().out.splitlines() if ln.startswith("| ")}
    assert "n/a" not in rows["full"]
    assert rows["part"].split("|")[3].strip() == "n/a"
    assert rows["part"].split("|")[2].strip() != "n/a"
    assert rows["none"].count("n/a") == 6


def test_smoke_all_on_two_archs(capsys):
    assert _script("torch_smoke_all").main(
        ["deepseek-7b", "xlstm-350m", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "ALL OK"
    kinds = [ln.split()[:2] for ln in lines[:-1]]
    assert kinds == [["deepseek-7b", k] for k in ("train", "prefill",
                                                  "decode")] + \
        [["xlstm-350m", k] for k in ("train", "prefill", "decode",
                                     "long_decode")]


_RUN = r"""
import runpy, sys
sys.argv = [{path!r}, "--device", "cpu"]
runpy.run_path({path!r}, run_name="__main__")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("isolated")
"""


@pytest.mark.parametrize("example,last", [
    ("torch_quickstart", "cost:"),
    ("torch_bridge_demo", "one IR, three frontends, two backends"),
])
def test_example_runs_on_the_cpu(example, last):
    path = os.path.join(ROOT, "examples", f"{example}.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _RUN.format(path=path)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "isolated" and lines[-2].startswith(last), lines
