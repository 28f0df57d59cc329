"""Devices and the numpy <-> torch bridge.

``resolve_device`` turns a ``device=`` option into a ``torch.device``,
failing at create time with the devices listed (the reference's
``JaxBackend._resolve_device``).  The IR's element types are numpy
dtypes (bf16 is ``ml_dtypes.bfloat16``); ``torch_dtype`` maps them, and
``as_tensor``/``to_numpy`` move arrays across without a float round trip.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from .core.types import as_dtype, bfloat16

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    bfloat16: torch.bfloat16,
}
_NUMPY_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(d: Any) -> torch.dtype:
    dt = as_dtype(d)
    if dt not in _TORCH_DTYPES:
        raise TypeError(f"no torch dtype for IR element type {dt}")
    return _TORCH_DTYPES[dt]


def numpy_dtype(d: torch.dtype) -> np.dtype:
    return _NUMPY_DTYPES[d]


def available() -> List[str]:
    return ["cpu"] + [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def resolve_device(spec: Any = None) -> torch.device:
    """``device=`` -> a concrete ``torch.device``.

    Accepts ``"cpu"``, ``"cuda"``/``"cuda:i"``, an int index of a CUDA
    device, ``"meta"`` (shapes and types only: a dry run), or a
    ``torch.device``; None means ``"cuda"``.  A device that is not
    attached fails here with the available devices listed -- a missing
    card is an error, never a silent move to the CPU."""
    if spec is None:
        spec = "cuda"
    if isinstance(spec, (int, np.integer)) and not isinstance(spec, bool):
        spec = f"cuda:{int(spec)}"
    if isinstance(spec, str):
        try:
            spec = torch.device(spec.lower())
        except RuntimeError as e:
            raise ValueError(f"malformed device {spec!r}; available: "
                             f"{available()}") from e
    if not isinstance(spec, torch.device):
        raise TypeError(
            f"device must be 'cpu', 'cuda[:i]', an int index or a "
            f"torch.device, got {type(spec).__name__}")
    if spec.type in ("cpu", "meta"):
        return torch.device(spec.type)
    if spec.type != "cuda":
        raise ValueError(f"unsupported device {spec}; available: "
                         f"{available()}")
    idx = 0 if spec.index is None else spec.index
    if not torch.cuda.is_available() or idx >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {spec} is not attached; available: {available()} "
            f"(pass device='cpu' to run on the CPU)")
    return torch.device("cuda", idx)


def as_tensor(x: Any, device: torch.device) -> torch.Tensor:
    """numpy array / scalar / tensor -> a tensor on ``device`` with the
    same element type (bf16 travels as its raw 16 bits)."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:   # (a 0-d array is; ascontiguousarray
        arr = np.ascontiguousarray(arr)   # would make it 1-d)
    if arr.dtype == bfloat16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_numpy(t: Any) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.is_meta:
        raise ValueError(f"a meta tensor {tuple(t.shape)} {t.dtype} has no "
                         f"values")
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(bfloat16)
    return t.numpy()
