"""The runtime substrate on torch: the checkpoint, data and fault cases of
``tests/test_runtime.py`` against the port's ``repro_torch.runtime``
(the sharding-policy cases are in ``tests/test_torch_partition.py``).  Beyond
them: the port's data pipeline gives the JAX package's batches, a
checkpoint crosses between the two packages in both directions, torch
tensors are saved through host numpy and restored onto a device, and
the asynchronous save's snapshot is taken before the caller's tensors
change in place (as a donated train step changes them on the card).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import checkpoint as j_checkpoint  # noqa: E402
from repro.runtime import data as j_data  # noqa: E402

from repro_torch.runtime.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                            CheckpointManager)
from repro_torch.runtime.data import (DataConfig, Prefetcher,  # noqa: E402
                                      SyntheticLM)
from repro_torch.runtime.fault import (Heartbeat,  # noqa: E402
                                       StragglerDetector, TransientError,
                                       retry_step)


# -- checkpoint ----------------------------------------------------------------
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, {"w": np.full((4,), step, np.float32),
                        "nested/x": np.arange(step)},
                 extra={"foo": step})
    assert mgr.latest_step() == 30
    step, tensors, extra = mgr.restore()
    assert step == 30 and extra["foo"] == 30
    np.testing.assert_array_equal(tensors["w"], np.full((4,), 30, np.float32))
    # keep=2: step 10 was garbage collected
    dirs = sorted(os.listdir(tmp_path))
    assert not any("0000000010" in d for d in dirs)


def test_checkpoint_atomic_no_partial(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.ones(3)})

    # a crashed save leaves only tmp dirs, never a bad step dir
    class Boom(Exception):
        pass

    def bad(*a, **k):
        raise Boom()

    monkeypatch.setattr(np, "save", bad)
    with pytest.raises(Boom):
        mgr.save(2, {"w": np.ones(3)})
    monkeypatch.undo()
    assert mgr.latest_step() == 1


def test_async_checkpointer_snapshot_isolation(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    ck = AsyncCheckpointer(mgr)
    w = np.zeros(8, np.float32)
    ck.save(5, {"w": w})
    w += 100.0  # mutate after snapshot; saved copy must be the old value
    ck.wait()
    _, tensors, _ = mgr.restore(5)
    np.testing.assert_array_equal(tensors["w"], np.zeros(8, np.float32))


def test_async_checkpointer_snapshots_tensors_before_an_in_place_step(
        tmp_path):
    """A donated step writes its state back into the same tensors: the
    snapshot is taken on the caller's thread, before that write."""
    mgr = CheckpointManager(str(tmp_path))
    ck = AsyncCheckpointer(mgr)
    w = torch.zeros(8)
    ck.save(5, {"p/w": w})
    w.add_(100.0)   # the next step, in place
    ck.wait()
    _, tensors, _ = mgr.restore(5)
    np.testing.assert_array_equal(tensors["p/w"], np.zeros(8, np.float32))


def test_restore_onto_a_device_gives_fresh_tensors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    src = {"p/w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
           "step": np.int32(4)}
    mgr.save(3, src)
    step, got, _ = mgr.restore(device="cpu")
    assert step == 3
    assert isinstance(got["p/w"], torch.Tensor)
    assert got["p/w"].device.type == "cpu"
    assert torch.equal(got["p/w"], src["p/w"])
    assert got["p/w"].data_ptr() != src["p/w"].data_ptr()
    with open(os.path.join(mgr._step_dir(3), "manifest.json")) as f:
        meta = json.load(f)["tensors"]
    assert meta["p/w"] == {"shape": [2, 3], "dtype": "<f4"}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_crosses_between_the_packages(tmp_path, writer):
    """One on-disk format: a checkpoint either package writes, the other
    restores bit for bit."""
    rng = np.random.default_rng(0)
    tensors = {"p/layers/w": rng.normal(size=(3, 4, 5)).astype(np.float32),
               "m/layers/w": rng.normal(size=(3, 4, 5)).astype(np.float32),
               "tok": rng.integers(0, 9, size=(7,)).astype(np.int32)}
    port = CheckpointManager(str(tmp_path))
    ref = j_checkpoint.CheckpointManager(str(tmp_path))
    (port if writer == "port" else ref).save(
        12, tensors, extra={"arch": "deepseek-7b"})
    reader = ref if writer == "port" else port
    step, got, extra = reader.restore()
    assert step == 12 and extra == {"arch": "deepseek-7b"}
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.cuda
def test_card_tensors_save_and_restore_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mgr = CheckpointManager(str(tmp_path))
    ck = AsyncCheckpointer(mgr)
    w = torch.randn(1024, device="cuda")
    want = w.cpu().clone()
    ck.save(1, {"p/w": w})
    w.mul_(3.0)
    ck.wait()
    _, got, _ = mgr.restore(device="cuda")
    assert got["p/w"].device.type == "cuda"
    assert torch.equal(got["p/w"].cpu(), want)
    _, host, _ = mgr.restore(device="cpu")
    assert torch.equal(host["p/w"], want)


# -- fault tolerance --------------------------------------------------------------
def test_retry_step_transient_then_ok():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientError("link flake")
        return "ok"

    assert retry_step(flaky, retries=5, backoff=0.0) == "ok"
    assert calls["n"] == 3

    def hopeless():
        raise TransientError("dead chip")

    with pytest.raises(TransientError):
        retry_step(hopeless, retries=2, backoff=0.0)


def test_straggler_detector():
    d = StragglerDetector(threshold=2.0, warmup=3)
    for i in range(10):
        assert not d.record(i, 1.0)
    assert d.record(10, 5.0)  # 5x the EMA
    assert not d.record(11, 1.0)  # EMA not poisoned by the straggler
    assert len(d.stragglers) == 1


def test_heartbeat(tmp_path):
    path = str(tmp_path / "hb.json")
    hb = Heartbeat(path, interval=0.0)
    hb.beat(7, loss=1.5)
    assert Heartbeat.is_alive(path, timeout=60)
    with open(path) as f:
        assert json.load(f)["step"] == 7
    assert not Heartbeat.is_alive(str(tmp_path / "nope.json"))


# -- data pipeline ------------------------------------------------------------------
def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=3,
                     n_shards=2, shard=0)
    a = SyntheticLM(cfg).batch(5)
    b = SyntheticLM(cfg).batch(5)  # fresh instance, same (seed, step, shard)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    other = SyntheticLM(DataConfig(1000, 16, 8, seed=3, n_shards=2, shard=1))
    assert not np.array_equal(a["tokens"], other.batch(5)["tokens"])
    assert a["tokens"].shape == (4, 16)  # global 8 over 2 shards


def test_prefetcher_resume_at_step():
    cfg = DataConfig(vocab_size=100, seq_len=4, global_batch=2, seed=0)
    src = SyntheticLM(cfg)
    pf = Prefetcher(src, start_step=7)
    step, batch = pf.next()
    pf.close()
    assert step == 7
    np.testing.assert_array_equal(batch["tokens"], src.batch(7)["tokens"])


@pytest.mark.parametrize("shard", [0, 1])
def test_data_matches_the_reference_batches(shard):
    """The two trainers see the same tokens: the port's pipeline gives
    the JAX package's batches for every (seed, step, shard)."""
    mine = SyntheticLM(DataConfig(257, 16, 4, seed=2, n_shards=2,
                                  shard=shard))
    theirs = j_data.SyntheticLM(j_data.DataConfig(257, 16, 4, seed=2,
                                                  n_shards=2, shard=shard))
    for step in (0, 1, 9):
        a, b = mine.batch(step), theirs.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
