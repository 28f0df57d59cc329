"""Element and tensor types for the nGraph-style IR.

The paper (sec. 2): "Nodes operate on multi-dimensional arrays, called
tensors... The inputs and attributes of a node determine the shape and
element types of the outputs."  Types are computed eagerly at node
construction time; an ill-typed graph cannot be built.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Sequence, Tuple

import numpy as np

try:  # bfloat16 et al. ship with jax
    import ml_dtypes

    bfloat16 = np.dtype(ml_dtypes.bfloat16)
    float8_e4m3 = np.dtype(ml_dtypes.float8_e4m3fn)
    float8_e5m2 = np.dtype(ml_dtypes.float8_e5m2)
except ImportError:  # pragma: no cover - ml_dtypes always present with jax
    bfloat16 = np.dtype(np.float32)
    float8_e4m3 = np.dtype(np.float32)
    float8_e5m2 = np.dtype(np.float32)

# Canonical element types, keyed by short name.
DTYPES = {
    "bool": np.dtype(np.bool_),
    "i8": np.dtype(np.int8),
    "i16": np.dtype(np.int16),
    "i32": np.dtype(np.int32),
    "i64": np.dtype(np.int64),
    "u8": np.dtype(np.uint8),
    "u32": np.dtype(np.uint32),
    "u64": np.dtype(np.uint64),
    "f8_e4m3": float8_e4m3,
    "f8_e5m2": float8_e5m2,
    "bf16": bfloat16,
    "f16": np.dtype(np.float16),
    "f32": np.dtype(np.float32),
    "f64": np.dtype(np.float64),
}
_NAME_BY_DTYPE = {v: k for k, v in DTYPES.items()}

FLOAT_DTYPES = {DTYPES[k] for k in ("f8_e4m3", "f8_e5m2", "bf16", "f16", "f32", "f64")}
INT_DTYPES = {DTYPES[k] for k in ("i8", "i16", "i32", "i64", "u8", "u32", "u64")}


def as_dtype(d: Any) -> np.dtype:
    """Coerce short names / numpy dtypes / python types to a canonical dtype."""
    if isinstance(d, str) and d in DTYPES:
        return DTYPES[d]
    dt = np.dtype(d)
    if dt not in _NAME_BY_DTYPE:
        raise TypeError(f"unsupported element type: {d!r}")
    return dt


def dtype_name(d: Any) -> str:
    return _NAME_BY_DTYPE[as_dtype(d)]


def is_float(d: Any) -> bool:
    return as_dtype(d) in FLOAT_DTYPES


def is_int(d: Any) -> bool:
    return as_dtype(d) in INT_DTYPES


@dataclasses.dataclass(frozen=True)
class TensorType:
    """Static shape + element type of one IR value."""

    shape: Tuple[int, ...]
    dtype: np.dtype

    def __init__(self, shape: Sequence[int], dtype: Any = "f32"):
        shape = tuple(int(s) for s in shape)
        if any(s < 0 for s in shape):
            raise ValueError(f"negative dimension in shape {shape}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "dtype", as_dtype(dtype))

    # -- convenience -------------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def with_shape(self, shape: Sequence[int]) -> "TensorType":
        return TensorType(shape, self.dtype)

    def with_dtype(self, dtype: Any) -> "TensorType":
        return TensorType(self.shape, dtype)

    def __repr__(self) -> str:
        dims = ",".join(str(s) for s in self.shape)
        return f"{dtype_name(self.dtype)}[{dims}]"


def broadcast_shapes(*shapes: Iterable[int]) -> Tuple[int, ...]:
    """Numpy-style broadcast of shapes; raises on mismatch."""
    try:
        return tuple(int(s) for s in np.broadcast_shapes(*[tuple(s) for s in shapes]))
    except ValueError as e:
        raise ValueError(f"shapes {shapes} are not broadcastable") from e


def promote_dtypes(*dtypes: Any) -> np.dtype:
    """Simple promotion: all equal, or float beats int, wider float wins."""
    ds = [as_dtype(d) for d in dtypes]
    first = ds[0]
    if all(d == first for d in ds):
        return first
    floats = [d for d in ds if d in FLOAT_DTYPES]
    if floats:
        # widest float by itemsize; bf16 vs f16 tie broken toward f32
        widest = max(floats, key=lambda d: d.itemsize)
        if len({d for d in floats}) > 1 and widest.itemsize == 2:
            return DTYPES["f32"]
        return widest
    return max(ds, key=lambda d: d.itemsize)
