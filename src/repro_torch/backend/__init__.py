"""The unified compilation API on torch (the port of ``repro.backend``).

    from repro_torch.backend import Backend, CompileOptions

    be = Backend.create("torch")                  # cuda:0; device="cpu" too
    ref = Backend.create("interpreter")           # the numpy oracle
    cf = be.compile(fn, CompileOptions(level="O2", use_pallas=True))
    outs = cf(*arrays)            # numpy in/out (synchronizes)
    cf.raw(*tensors)              # device tensors in/out, no sync
    be.cache_stats()              # compile-cache hits/misses

The persistent disk cache and the autotuner are later slices and are
refused with a clear error (``OptionsError``).
"""
from .base import (Backend, CacheStats, available_backends,  # noqa: F401
                   register_backend)
from .compiled import CompiledFunction  # noqa: F401
from .options import CompileOptions, OptionsError  # noqa: F401
# each backend module registers itself
from . import interpreter as _interpreter  # noqa: F401
from . import torch_backend as _torch_backend  # noqa: F401
