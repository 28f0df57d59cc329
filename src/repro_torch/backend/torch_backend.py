"""Torch backend: pipeline + IR emission behind the Backend API (the port
of ``repro/backend/jax_backend.py``).

    be = Backend.create("torch")                  # the card (cuda:0)
    be = Backend.create("torch", device="cpu")    # the CPU, as tests ask
    cf = be.compile(fn, CompileOptions(level="O2", use_pallas=True))

``use_pallas=True`` selects the hand-written Hopper kernels at the
emitter's kernel-selection points; ``interpret_pallas`` has no meaning
here and is ignored.  ``donate_argnums`` is honoured as "may reuse in
place": the emitted program drops every value after its last use, so a
donated input the caller no longer references is free for the
allocator to reuse within the dispatch.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from ..core.function import Function
from ..devices import resolve_device, to_numpy
from ..transformers.torch_emit import EmitCtx, emit_callable
from .base import Backend, register_backend
from .options import CompileOptions, OptionsError


@register_backend
class TorchBackend(Backend):
    """Compiles IR -> an eager torch program on one device."""

    name = "torch"
    default_level = "O1"

    def __init__(self, **backend_opts):
        device = backend_opts.pop("device", None)
        if backend_opts:
            raise TypeError(
                f"unknown torch backend opts {sorted(backend_opts)}; "
                f"supported: ['device']")
        self.device = resolve_device(device)
        # one stable string per physical device for the instance memo
        super().__init__(device=str(self.device))

    def _codegen(self, fn: Function, options: CompileOptions
                 ) -> Tuple[Callable, Optional[Callable], Optional[Callable]]:
        if options.mode != "jit":
            raise OptionsError(
                f"mode={options.mode!r}: sharded execution comes with the "
                f"tensor-parallel slice of the torch port")
        ctx = EmitCtx(self.device, use_pallas=options.use_pallas,
                      attn_impl=options.attn_impl,
                      attn_chunk=options.attn_chunk)
        run = emit_callable(fn, ctx)
        dev = self.device

        def call(*args):
            outs = run(*args)
            if dev.type == "cuda":
                import torch
                torch.cuda.synchronize(dev)
            return [to_numpy(o) for o in outs]

        return call, run, None
