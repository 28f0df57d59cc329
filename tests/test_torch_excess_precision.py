"""Why the bf16 serving modes split a greedy token: XLA's excess precision.

By default XLA may keep a bf16 value in f32 where the IR converts it to
bf16 (``--xla_allow_excess_precision``, on by default).  The port rounds
wherever the IR's converts say.  With excess precision off, the
reference's serve CLI gives the port's greedy tokens exactly, at the CI's
reduced workload (``scripts/torch_serving_matrix.py``'s ``CI_WORKLOAD``):
seed 0 through the continuous leg and seed 1 through the donated leg,
where the two packages' tokens differ under XLA's defaults.  So the split
between the serving modes in bf16 (the donated leg's ``Attention``
rounds its probabilities to bf16, the continuous leg's row-position
composition keeps them in f32) is the reference's own, and the port
copies it.

The reference runs in a subprocess of its own per flag setting (XLA
reads ``XLA_FLAGS`` once, when JAX starts); the port's serve CLI runs in
this process on the CPU with the same flags.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (leg, seed): the two splits between the packages under XLA's defaults
CASES = (("continuous", 0), ("donated", 1))
NO_EXCESS = "--xla_allow_excess_precision=false"


def _matrix():
    spec = importlib.util.spec_from_file_location(
        "torch_serving_matrix",
        os.path.join(ROOT, "scripts", "torch_serving_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(leg, seed, path):
    return ["--arch", "deepseek-7b", "--reduced",
            *_matrix().CI_WORKLOAD[leg].split(), "--seed", str(seed),
            "--report-json", str(path)]


def _reference(out_dir, xla_flags):
    """Start the reference's serve CLI over :data:`CASES` in one process
    with ``XLA_FLAGS=xla_flags`` on the CPU; returns the process and the
    report path of each case."""
    paths = {c: out_dir / f"{c[0]}-{c[1]}.json" for c in CASES}
    calls = [_argv(leg, seed, paths[(leg, seed)]) for leg, seed in CASES]
    code = ("import sys\nfrom repro.launch import serve\n"
            f"for argv in {calls!r}:\n"
            "    assert serve.main(argv) == 0, argv\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=xla_flags,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, paths


def _tokens(path):
    with open(path) as f:
        return json.load(f)["results"]


def test_reference_without_excess_precision_gives_the_port_tokens(
        tmp_path):
    runs = {}
    for name, flags in (("exact", NO_EXCESS), ("default", "")):
        out = tmp_path / name
        out.mkdir()
        runs[name] = _reference(out, flags)
    port = {}
    for leg, seed in CASES:
        path = tmp_path / f"port-{leg}-{seed}.json"
        assert serve.main(_argv(leg, seed, path) + ["--device", "cpu"]) == 0
        port[(leg, seed)] = _tokens(path)
    ref = {}
    for name, (proc, paths) in runs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        ref[name] = {c: _tokens(p) for c, p in paths.items()}
    for case in CASES:
        assert ref["exact"][case] == port[case], case
        # under XLA's defaults the same case differs: excess precision is
        # the cause, not the port
        assert ref["default"][case] != port[case], case
