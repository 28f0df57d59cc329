"""Sharding-aware checkpointing with async save and elastic restore.

Design (targets 1000+ nodes; degenerates cleanly to 1 process here):
  * a checkpoint is a directory: ``manifest.json`` + one ``.npy`` per
    tensor (per-process file subsets on a real cluster);
  * the manifest stores *logical* shapes/dtypes + step + data-pipeline
    state, never mesh shape — restore re-shards onto whatever mesh exists
    (elastic scaling: restore on a different chip count just works);
  * saves are atomic (tmp dir + rename) so a node failure mid-save never
    corrupts the latest checkpoint;
  * ``AsyncCheckpointer`` snapshots to host memory synchronously and
    writes on a background thread, keeping the train loop running.

On torch the tensors may live on the card: a save copies them to host
numpy (:func:`repro_torch.devices.to_numpy`), and ``restore(device=...)``
puts the arrays on a ``torch.device``.  The on-disk format is the
reference's, so a checkpoint crosses between the two packages.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..devices import as_tensor, resolve_device, to_numpy


def _np(x) -> np.ndarray:
    return to_numpy(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and \
                    os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
        return max(steps) if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tensors: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> str:
        host = {k: _np(v) for k, v in tensors.items()}
        return self._write(step, host, extra or {})

    def _write(self, step: int, host: Dict[str, np.ndarray],
               extra: Dict[str, Any]) -> str:
        final = self._step_dir(step)
        tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=self.directory)
        try:
            manifest = {
                "step": step,
                "time": time.time(),
                "extra": extra,
                "tensors": {
                    k: {"shape": list(v.shape), "dtype": v.dtype.str}
                    for k, v in host.items()
                },
            }
            for k, v in host.items():
                np.save(os.path.join(tmp, self._fname(k)), v, allow_pickle=False)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    @staticmethod
    def _fname(key: str) -> str:
        return key.replace("/", "__") + ".npy"

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore(self, step: Optional[int] = None, device: Any = None):
        """Load tensors: numpy arrays, or with ``device`` (``"cpu"``,
        ``"cuda[:i]"`` or a ``torch.device``) fresh tensors on it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self._step_dir(step)
        dev = resolve_device(device) if device is not None else None
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out: Dict[str, Any] = {}
        for k, meta in manifest["tensors"].items():
            arr = np.load(os.path.join(d, self._fname(k)), allow_pickle=False)
            assert list(arr.shape) == meta["shape"], f"{k}: manifest mismatch"
            out[k] = arr if dev is None else as_tensor(arr, dev)
        return manifest["step"], out, manifest.get("extra", {})


class AsyncCheckpointer:
    """Snapshot synchronously, write in the background; at most one
    outstanding save (a newer save waits for the previous write)."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tensors: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # snapshot now, on the caller's thread: on the card the donated
        # state is overwritten in place by the next step, and the writer
        # thread touches numpy only
        host = {k: _np(v).copy() for k, v in tensors.items()}

        def work():
            try:
                self.manager._write(step, host, extra or {})
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
