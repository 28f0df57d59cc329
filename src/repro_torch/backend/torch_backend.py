"""Torch backend: pipeline + IR emission behind the Backend API (the port
of ``repro/backend/jax_backend.py``).

    be = Backend.create("torch")                  # the card (cuda:0)
    be = Backend.create("torch", device="cpu")    # the CPU, as tests ask
    cf = be.compile(fn, CompileOptions(level="O2", use_pallas=True))

``use_pallas=True`` selects the hand-written Hopper kernels at the
emitter's kernel-selection points; ``interpret_pallas`` has no meaning
here and is ignored.

``static_jit=True`` (the default) on a CUDA device is the reference's
``jax.jit``: a compiled function runs eagerly on its first call and
from then on replays a CUDA graph captured for the device tensors it is
called with (:mod:`.graphed`); donated inputs are written back in place
and returned as the outputs they pair with, and no other input is
written.  On the CPU, or with
``static_jit=False``, the emitted program runs eagerly op by op, and
``donate_argnums`` means "may reuse": the program drops every value
after its last use, so a donated input the caller no longer references
is free for the allocator to reuse within the dispatch.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.function import Function
from ..devices import resolve_device, to_numpy
from ..transformers.torch_emit import EmitCtx, emit_callable
from .base import Backend, register_backend
from .graphed import GraphedProgram, pair_donations
from .options import CompileOptions, OptionsError


@register_backend
class TorchBackend(Backend):
    """Compiles IR -> a torch program on one device: eager, or captured
    as a CUDA graph on the card (``static_jit``)."""

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
        # every graph of this backend captures on one side stream into
        # one memory pool (made at the first capture-enabled compile)
        self._graph_pool = None
        self._capture_stream = None

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
        if dev.type == "cuda" and options.static_jit:
            with self._lock:
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                    self._capture_stream = torch.cuda.Stream(dev)
            run = GraphedProgram(
                run, name=fn.name, device=dev, in_types=fn.in_types,
                out_types=fn.out_types,
                donate_argnums=options.donate_argnums,
                pool=self._graph_pool, stream=self._capture_stream)
        else:
            run.donation = pair_donations(fn.in_types, fn.out_types,
                                          options.donate_argnums)

        def call(*args):
            outs = run(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return [to_numpy(o) for o in outs]

        return call, run, None
