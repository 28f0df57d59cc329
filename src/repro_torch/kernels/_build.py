"""Build and load the port's Hopper kernels.

The CUDA sources under ``csrc/`` have a plain C interface.  At first use
they are compiled for ``sm_90a`` by ``nvcc`` (one process per source, all
started together, then one link) into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of the sources and flags, and loaded with :mod:`ctypes`.  Every
pointer and the stream go in as ``c_void_p``; every C entry point returns
``cudaGetLastError()`` after its launches, and :func:`check` raises when
that is not 0 (a refused launch never runs and ``synchronize`` would not
report it).

Nothing here runs at import: the CPU tests import every module, and this
machine-dependent work happens only when a kernel is first called on a
CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v costs nothing and keeps each kernel's registers, shared
# memory and spills in build_log
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# dtype codes, mirrored by csrc/common.cuh (enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes (all return int = cudaError_t)
SIGNATURES = {
    "repro_matmul": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_norm_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "repro_swiglu": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                              _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "repro_batched_matmul": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L,
                             _L, _I, _I, _P],
    "repro_wgmma_probe": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: List[str] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's kernels are "
            "built from csrc/ at first use and need the CUDA toolkit")
    return str(path)


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (cached by a hash of
    the sources and flags) and return its path; the compiler's report
    lands in :data:`build_log`."""
    tag = _digest()
    out = BUILD_DIR / f"libreprokernels_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objdir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = objdir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _obj, proc in procs:
        log, _ = proc.communicate()
        build_log.append(f"== {src.name}\n{log}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = objdir / out.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _s, o, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or none
    shutil.rmtree(objdir, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA kernel launch failed with cudaError {rc}")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``device`` current, and raise
    if its launches failed.  The launches (and each kernel's per-device
    shared-memory limit, ``csrc/common.cuh``'s ``once_per_device``) act
    on the thread's current device, which need not be the operands'."""
    with torch.cuda.device(device):
        rc = getattr(lib(), entry)(*args)
    check(rc, entry.removeprefix("repro_"))


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, name: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: no kernel for dtype {t.dtype}")
    return code


def operand(t: torch.Tensor, name: str, device: torch.device) -> torch.Tensor:
    """A kernel operand: on ``device``, dense row-major, 16-byte aligned
    (the kernels read rows as 16-byte vectors).  A strided or unaligned
    view is copied; a tensor on another device raises."""
    if t.device != device:
        raise ValueError(
            f"{name}: operand on {t.device}, kernel runs on {device}")
    if not t.is_contiguous():
        t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


