"""The torch port stands alone: it imports torch and numpy, never jax and
nothing of the JAX package ``repro``; and its entry points run on the
card unless the caller asks for the CPU.  The port's package, its
``chip_smoke.py``, its scripts (``scripts/torch_*.py``) and its examples
(``examples/torch_*.py``) are held to that;
``scripts/check_torch_parity.py`` is the one file outside the tests that
imports both packages, by design."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")
SCRIPTS = [os.path.join(ROOT, "scripts", f"{n}.py")
           for n in ("torch_serve_load", "torch_chaos_probe",
                     "torch_cache_tool", "torch_profile_edges",
                     "torch_serving_matrix", "torch_probe_buffers",
                     "torch_make_tables", "torch_smoke_all",
                     "torch_bench", "torch_bench_to_json",
                     "torch_prefix_shapes", "torch_phase_times",
                     "torch_bmm_bits", "torch_train_gaps",
                     "torch_flash_bits")]
# the examples whose work sits behind ``if __name__ == "__main__"``: the
# probe imports them; torch_quickstart and torch_bridge_demo run when
# imported, and tests/test_torch_tooling.py runs them isolated
EXAMPLES = [os.path.join(ROOT, "examples", f"torch_{n}.py")
            for n in ("serve_lm", "train_lm", "multi_arch_dryrun",
                      "serving_demo")]
EXAMPLES_RUN = [os.path.join(ROOT, "examples", f"torch_{n}.py")
                for n in ("quickstart", "bridge_demo")]


def _port_files():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield from SCRIPTS
    yield from EXAMPLES
    yield from EXAMPLES_RUN


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import_statement(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, ROOT)}:{node.lineno} " \
                        f"imports {bad}"


_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
mods = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    mods.append(m.name)
assert all(m in mods for m in ("repro_torch.launch.roofline",
                               "repro_torch.launch.dryrun")), mods
import chip_smoke  # noqa: F401  (phases import the port lazily)
import importlib.util
for path in {scripts!r} + {examples!r}:
    spec = importlib.util.spec_from_file_location("script", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), "modules;", "forbidden:", bad)
assert not bad, bad
import torch
from repro_torch.backend import Backend
if torch.cuda.is_available():
    assert Backend.create("torch", fresh=True).device.type == "cuda"
else:
    try:
        Backend.create("torch", fresh=True)
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("Backend.create('torch') ran without a card")
    assert Backend.create("torch", device="cpu").device.type == "cpu"
print("ok")
"""


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c",
         _PROBE.format(src=SRC, root=ROOT, scripts=SCRIPTS,
                       examples=EXAMPLES)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


_DRYRUN = r"""
import sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun
rc = dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                  "--out-dir", {out!r}])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert rc == 0 and not bad, (rc, bad)
print("ok")
"""


def test_dry_run_runs_without_jax_or_repro(tmp_path):
    """The dry run (the pjit glue, mode='pjit' on meta devices, the
    roofline) runs a full-width cell with neither jax nor the reference
    imported."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _DRYRUN.format(src=SRC, out=str(tmp_path))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DRY-RUN GREEN" in out.stdout and \
        out.stdout.strip().endswith("ok")


def test_engine_and_serve_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the CPU-only refusal cannot show")
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import EngineConfig, ServeEngine
    with pytest.raises(RuntimeError, match="not attached"):
        ServeEngine(get_config("deepseek-7b").reduced(),
                    EngineConfig(mode="paged"))


def test_serve_http_refuses_a_missing_card():
    """The CLI's front-door path defaults to the card like its local
    path: without ``--device cpu`` it fails before it listens."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the CPU-only refusal cannot show")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="not attached"):
        serve.main(["--reduced", "--serve-http", "--port", "0"])


def test_train_refuses_a_missing_card(tmp_path):
    """The training CLI defaults to the card too: without ``--device
    cpu`` it fails before the first step."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the CPU-only refusal cannot show")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="not attached"):
        train.main(["--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
