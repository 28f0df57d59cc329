"""The port's HTTP front door (``repro_torch.launch.server``) over a torch
engine on the CPU, case by case after ``tests/test_server.py``: streamed
tokens equal the direct engine's, admission maps onto the queue-aware
``can_admit`` with deterministic 429/503 backpressure, a client that
hangs up gives back its slot and pages, the ``timeout`` knob becomes a
deadline, oversized bodies get 413, and a drain finishes in-flight
streams and returns every KV page.

Beyond the reference: f32 greedy streams served by the torch server
equal the JAX package's engine on the same weights; the CLI's
``--serve-http`` path serves ``scripts/torch_serve_load.py``'s clients
and drains on SIGTERM; and the chaos probe and the backpressure probe
pass on the CPU.  Every engine names its mode (``paged``).
"""
import asyncio
import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import loadgen  # noqa: E402
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.launch.server import (ServeHTTPServer,  # noqa: E402
                                       running_server)
from repro_torch.models.weights import params_from_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("deepseek-7b").reduced()


def _engine(slots=2, max_len=16, cfg=CFG, **kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("chunk_steps", 3)
    return ServeEngine(cfg, EngineConfig(mode="paged", slots=slots,
                                         max_len=max_len, seed=0,
                                         device="cpu", **kw))


def _poll(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"{what} (within {timeout}s)")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_server_streams_match_direct_engine():
    """3 concurrent clients on 2 slots: every streamed token equals the
    direct engine's decode of the same prompt, and the drain leaves the
    page pool empty."""
    P, G, n = 4, 6, 3
    prompts = loadgen.make_prompts(n, P, CFG.vocab, seed=0)
    ref_eng = _engine()
    rids = [ref_eng.submit(p, G) for p in prompts]
    ref = {str(i): list(ref_eng.run().results[r]) for i, r in enumerate(rids)}

    with running_server(_engine(), max_wait_queue=n) as srv:
        res = loadgen.run_load(srv.base_url, prompts, G)
        assert res.statuses == {200: n} and not res.errors
        metrics = loadgen.fetch_json(srv.base_url, "/v1/metrics")
        assert metrics["engine"]["mode"] == "paged"
        assert metrics["server"]["requests_completed"] == n
        assert metrics["server"]["ttft_p95_ms"] > 0
        health = loadgen.fetch_json(srv.base_url, "/healthz")
        assert health == {"ok": True, "health": "ok", "draining": False}
    assert res.results == ref
    assert srv.drain_ok is True
    assert srv.engine.pool.pages_in_use == 0
    doc = srv.report_doc()
    assert doc["mode"] == "server" and doc["engine_mode"] == "paged"
    assert doc["results"] == ref
    assert doc["server"]["tokens_streamed"] == n * G


def test_backpressure_429_then_503_through_drain():
    """1 slot, wait queue 0: B while A streams -> 429; C after drain
    begins -> 503; A still finishes every token through the drain."""
    P, G = 4, 48
    srv = ServeHTTPServer(_engine(slots=1, max_len=P + G, chunk_steps=1),
                          max_wait_queue=0)
    srv.start_in_thread()
    url = srv.base_url
    prompt = [int(t) for t in loadgen.make_prompts(1, P, CFG.vocab)[0]]

    a_box = {}

    def client_a():
        a_box["res"] = asyncio.run(loadgen.stream_generate(
            url, {"prompt": prompt, "max_new": G, "tag": "A"}, timeout=300))

    a = threading.Thread(target=client_a, daemon=True)
    a.start()
    _poll(lambda: loadgen.fetch_json(url, "/v1/metrics")
          ["engine"]["active_slots"] >= 1, "A never took the slot")

    rb = asyncio.run(loadgen.stream_generate(
        url, {"prompt": prompt, "max_new": G}, timeout=30))
    assert rb.status == 429, (rb.status, rb.error)

    stopper = threading.Thread(target=srv.shutdown, daemon=True)
    stopper.start()
    _poll(lambda: loadgen.fetch_json(url, "/healthz")["draining"],
          "drain never started")
    rc = asyncio.run(loadgen.stream_generate(
        url, {"prompt": prompt, "max_new": G}, timeout=30))
    assert rc.status == 503, (rc.status, rc.error)

    a.join(300)
    assert not a.is_alive()
    ra = a_box["res"]
    assert ra.status == 200 and not ra.error and len(ra.tokens) == G
    stopper.join(120)
    assert not stopper.is_alive()
    assert srv.drain_ok is True
    snap = srv.stats.snapshot()
    assert snap["rejected_429"] == 1 and snap["rejected_503"] == 1


def test_text_prompt_and_request_validation():
    """'text' folds bytes into the vocab; malformed bodies are 400 with
    the reason, unknown routes 404, wrong methods 405."""
    with running_server(_engine()) as srv:
        url = srv.base_url
        text = "hi"
        r = asyncio.run(loadgen.stream_generate(
            url, {"text": text, "max_new": 3}, timeout=120))
        assert r.status == 200 and len(r.tokens) == 3 and not r.error
        # same ids submitted directly must decode identically
        ids = np.asarray([b % CFG.vocab for b in text.encode()], np.int32)
        eng = _engine()
        rid = eng.submit(ids, 3)
        assert r.tokens == list(eng.run().results[rid])

        for bad, why in [
            ({}, "prompt"),                                  # no prompt
            ({"prompt": []}, "prompt"),                      # empty
            ({"prompt": [0], "max_new": 0}, "max_new"),      # bad max_new
            ({"prompt": [CFG.vocab]}, "prompt ids"),         # out of vocab
            ({"prompt": [0], "max_new": 99}, "max_len"),     # too long
            ({"prompt": [0], "tag": [1]}, "tag"),            # bad tag type
            ({"prompt": [0], "max_new": 2, "temperature": -1},
             "temperature"),
        ]:
            status, doc = asyncio.run(loadgen.http_json(
                url, "POST", "/v1/generate", bad))
            assert status == 400, (bad, status, doc)
            assert why in doc["error"], (bad, doc)
        status, doc = asyncio.run(loadgen.http_json(url, "GET", "/nope"))
        assert status == 404
        status, doc = asyncio.run(loadgen.http_json(
            url, "DELETE", "/v1/generate"))
        assert status == 405
    assert srv.drain_ok is True


def test_server_requires_step_capable_engine():
    eng = ServeEngine(CFG, EngineConfig(mode="donated", slots=1, max_len=8,
                                        seed=0, device="cpu"))
    with pytest.raises(ValueError, match="step\\(\\)-capable"):
        ServeHTTPServer(eng)
    with pytest.raises(ValueError, match="max_wait_queue"):
        ServeHTTPServer(_engine(), max_wait_queue=-1)
    with pytest.raises(ValueError, match="max_body_bytes"):
        ServeHTTPServer(_engine(), max_body_bytes=0)
    with pytest.raises(ValueError, match="heartbeat_s"):
        ServeHTTPServer(_engine(), heartbeat_s=0)


def test_client_disconnect_reclaims_slot_and_pages():
    """A client that hangs up mid-stream must not strand its request:
    the server cancels it, the engine returns the slot and every page,
    and the freed capacity admits the next request immediately."""
    P, G = 4, 64
    eng = _engine(slots=1, max_len=P + G, chunk_steps=1)
    with running_server(eng, max_wait_queue=2) as srv:
        url = srv.base_url
        prompt = [int(t) for t in loadgen.make_prompts(1, P, CFG.vocab)[0]]
        r = asyncio.run(loadgen.stream_generate(
            url, {"prompt": prompt, "max_new": G}, timeout=120,
            disconnect_after=2))
        assert r.disconnected and len(r.tokens) >= 2
        _poll(lambda: loadgen.fetch_json(url, "/v1/metrics")
              ["engine"]["counters"]["cancelled"] >= 1,
              "disconnect never cancelled the request")
        _poll(lambda: loadgen.fetch_json(url, "/v1/metrics")
              ["engine"]["active_slots"] == 0,
              "cancelled request never released its slot")
        assert loadgen.fetch_json(url, "/v1/metrics")["engine"][
            "pages_in_use"] == 0
        # the freed slot admits a fresh request, which runs to completion
        r2 = asyncio.run(loadgen.stream_generate(
            url, {"prompt": prompt, "max_new": 4}, timeout=120))
        assert r2.status == 200 and not r2.error
        assert r2.terminal == "completed" and len(r2.tokens) == 4
        snap = loadgen.fetch_json(url, "/v1/metrics")["server"]
        assert snap["client_disconnects"] >= 1
    assert srv.drain_ok is True
    assert eng.pool.pages_in_use == 0 and eng.pool.active == 0
    assert srv.engine_report.counters["cancelled"] == 1
    assert srv.engine_report.counters["completed"] == 1


def test_request_timeout_maps_to_deadline():
    """The 'timeout' knob becomes an engine deadline: the stream ends
    with a distinct deadline_exceeded terminal status (and the pool
    drains clean), instead of running to natural completion."""
    P, G = 4, 48
    eng = _engine(slots=1, max_len=P + G, chunk_steps=1)
    with running_server(eng, max_wait_queue=2) as srv:
        url = srv.base_url
        prompt = [int(t) for t in loadgen.make_prompts(1, P, CFG.vocab)[0]]
        r = asyncio.run(loadgen.stream_generate(
            url, {"prompt": prompt, "max_new": G, "timeout": 0.001},
            timeout=120))
        assert r.status == 200
        assert r.terminal == "deadline_exceeded", (r.terminal, r.error)
        assert len(r.tokens) < G
        _poll(lambda: loadgen.fetch_json(url, "/v1/metrics")
              ["engine"]["counters"]["deadline_exceeded"] >= 1,
              "deadline_exceeded counter never moved")
        # bad timeout values are rejected up front
        status, doc = asyncio.run(loadgen.http_json(
            url, "POST", "/v1/generate",
            {"prompt": prompt, "max_new": 2, "timeout": -1}))
        assert status == 400 and "deadline" in doc["error"]
    assert srv.drain_ok is True
    assert eng.pool.pages_in_use == 0
    assert srv.engine_report.counters["deadline_exceeded"] == 1


def test_max_body_bytes_413():
    """Oversized request bodies bounce with 413 + a JSON reason before
    being read into memory; the connection still gets a clean answer and
    the server keeps serving."""
    eng = _engine()
    with running_server(eng, max_body_bytes=256) as srv:
        url = srv.base_url
        big = {"prompt": [0, 1, 2], "max_new": 2, "tag": "x" * 512}
        status, doc = asyncio.run(loadgen.http_json(
            url, "POST", "/v1/generate", big))
        assert status == 413, (status, doc)
        assert "max_body_bytes" in doc["error"]
        r = asyncio.run(loadgen.stream_generate(
            url, {"prompt": [0, 1, 2], "max_new": 2}, timeout=120))
        assert r.status == 200 and not r.error and len(r.tokens) == 2
        snap = loadgen.fetch_json(url, "/v1/metrics")["server"]
        assert snap["rejected_413"] == 1
    assert srv.drain_ok is True


def test_served_f32_streams_equal_the_jax_engine():
    """5 concurrent clients, two sharing a prefix, on 2 slots of a torch
    server in f32: each stream equals the JAX package's paged engine's
    tokens for that prompt, on the JAX engine's weights.  (Whether the
    sharer attaches the prefix pages depends on arrival order; the
    tokens do not.)"""
    G = 7
    jcfg = dataclasses.replace(j_get_config("deepseek-7b").reduced(),
                               compute_dtype="f32")
    tcfg = dataclasses.replace(CFG, compute_dtype="f32")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (5, 11, 9, 14, 3)]
    prompts[2][:8] = prompts[1][:8]   # two full shared pages
    jeng = JServeEngine(jcfg, slots=2, max_len=24, mode="paged", seed=0,
                        page_size=4, chunk_steps=3)
    jids = [jeng.submit(p, G) for p in prompts]
    jrep = jeng.run()
    ref = {str(i): [int(t) for t in jrep.results[r]]
           for i, r in enumerate(jids)}
    eng = _engine(max_len=24, cfg=tcfg,
                  params=params_from_numpy(jeng.params, "cpu"))
    with running_server(eng, max_wait_queue=len(prompts)) as srv:
        res = loadgen.run_load(srv.base_url, prompts, G)
    assert res.statuses == {200: len(prompts)} and not res.errors
    assert res.results == ref
    assert srv.drain_ok is True and eng.pool.pages_in_use == 0


def test_cli_serve_http_drains_on_sigterm(tmp_path):
    """``python -m repro_torch.launch.serve --serve-http`` on the CPU:
    the load script's clients get the tokens the CLI's local path
    decodes for the same flags, SIGTERM drains it, and the report keys
    the results by the clients' tags."""
    from repro_torch.launch import serve
    flags = ["--reduced", "--device", "cpu", "--requests", "3",
             "--prompt-len", "4", "--gen", "6"]
    local = tmp_path / "local.json"
    assert serve.main(flags + ["--report-json", str(local)]) == 0
    want = json.loads(local.read_text())["results"]

    report = tmp_path / "served.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve-http",
         "--port", "0", "--report-json", str(report)] + flags,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert "listening on http://" in line, line
        url = line.split("listening on ")[1].split()[0]
        load = _script("torch_serve_load")
        assert load.main(["--base-url", url, "--reduced", "--requests",
                          "3", "--prompt-len", "4", "--gen", "6",
                          "--ready-timeout", "60"]) == 0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert proc.returncode == 0, out
    assert "[serve-http] drained: 3 completed / 3 accepted" in out, out
    doc = json.loads(report.read_text())
    assert doc["drain_ok"] is True and doc["mode"] == "server"
    assert doc["results"] == want


def test_chaos_probe_passes_on_the_cpu(tmp_path):
    report = tmp_path / "chaos.json"
    probe = _script("torch_chaos_probe")
    assert probe.main(["--device", "cpu", "--report-json",
                       str(report)]) == 0
    doc = json.loads(report.read_text())
    assert sorted(doc["scenarios"]) == sorted(probe.SCENARIOS)
    assert all(s["ok"] for s in doc["scenarios"].values())
    assert doc["counters"]["cancelled"] > 0
    assert doc["counters"]["deadline_exceeded"] > 0
    assert doc["counters"]["engine_errors"] > 0


def test_backpressure_probe_passes_on_the_cpu(capsys):
    load = _script("torch_serve_load")
    assert load.main(["--probe-backpressure", "--device", "cpu",
                      "--reduced"]) == 0
    assert "[probe-backpressure] ok on cpu" in capsys.readouterr().out


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA-graph capture and the Hopper "
                    "kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_engine_thread_captures_graphs_the_main_thread_ran(cuda_device):
    """The server's engine thread is the first to capture a graph for a
    second engine's tensors, after the main thread ran (and captured)
    the same compiled functions for the first engine: the thread makes
    its own cuBLAS handle before the capture, and its streams equal the
    first engine's tokens."""
    P, G, n = 6, 8, 3
    prompts = loadgen.make_prompts(n, P, CFG.vocab, seed=3)
    opts = dict(max_len=24, chunk_steps=2, device="cuda")

    def engine():
        return ServeEngine(CFG, EngineConfig(mode="paged", slots=2,
                                             seed=0, page_size=4, **opts))

    first = engine()
    for _ in range(2):   # eager first calls, then captures, on this thread
        rids = [first.submit(p, G) for p in prompts]
        rep = first.run()
    want = {str(i): [int(t) for t in rep.results[r]]
            for i, r in enumerate(rids)}
    assert first.cf.raw.captured
    captures = first.cf.raw.captures
    with running_server(engine(), max_wait_queue=n) as srv:
        res = loadgen.run_load(srv.base_url, prompts, G)
    assert res.statuses == {200: n} and not res.errors, res.errors
    assert res.results == want
    assert first.cf.raw.captures > captures   # the engine thread captured
    assert srv.drain_ok is True
