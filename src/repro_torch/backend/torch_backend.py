"""Torch backend: pipeline + IR emission behind the Backend API (the port
of ``repro/backend/jax_backend.py``).

    be = Backend.create("torch")                  # the card (cuda:0)
    be = Backend.create("torch", device="cpu")    # the CPU, as tests ask
    cf = be.compile(fn, CompileOptions(level="O2", use_pallas=True))

``use_pallas=True`` selects the hand-written Hopper kernels at the
emitter's kernel-selection points; ``interpret_pallas`` has no meaning
here and is ignored.

With a cache dir (``cache_dir`` or ``$REPRO_CACHE_DIR``) the optimized
graph persists on disk, keyed with the device's name among the rest
(:mod:`.diskcache`).  There is no executable format: a disk hit skips
the pass pipeline, then emits the program again and, on the card,
captures it at its second call as any compile does.

``static_jit=True`` (the default) on a CUDA device is the reference's
``jax.jit``: a compiled function runs eagerly on its first call and
from then on replays a CUDA graph captured for the device tensors it is
called with (:mod:`.graphed`); donated inputs are written back in place
and returned as the outputs they pair with, and no other input is
written.  On the CPU, or with
``static_jit=False``, the emitted program runs eagerly op by op, and
``donate_argnums`` means "may reuse": the program drops every value
after its last use, so a donated input the caller no longer references
is free for the allocator to reuse within the dispatch.  On the card,
eager or captured, a donated input given as a device tensor takes its
output as soon as nothing reads it any more and is returned in its
place (:func:`..transformers.torch_emit.emit_callable`).

``CompileOptions(mode="shardmap", partition="tp", mesh_shape=(N,))``
runs the PartitionGraph pass last in the pipeline and the partitioned
graph through the shard executor (:mod:`.sharded`) over a mesh of N
shards (:func:`.sharding.mesh_for_options`; ``mesh=`` names the devices,
e.g. two shards on one card).  Callers pass and receive global tensors.
A mesh on the backend's own device is captured whole like any program.

``CompileOptions(mode="pjit", mesh=..., in_shardings=...)`` is the same
pass and executor with the specs the pjit glue gives
(:func:`.sharding.pjit_partition`; a ``pod`` axis folded into ``data``).
On a meta mesh (``make_production_mesh()``), or with
``device="meta"``, the compile emits the plan and a call walks shard 0
on meta tensors (``ShardedProgram(sole_shard=True)``): shapes, types,
``.cost`` and ``.memory_plan`` with no card.  The numpy convention
(``cf(...)``) returns meta tensors there, which hold no values.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.function import Function
from ..devices import resolve_device, to_numpy
from ..transformers.torch_emit import EmitCtx, emit_callable
from . import diskcache
from .base import Backend, register_backend
from .graphed import GraphedProgram, pair_donations
from .options import CompileOptions
from .sharded import ShardedProgram
from .sharding import fold_pods, is_meta, mesh_for_options


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

    def clear_cache(self) -> None:
        """The base reset, and a new capture pool for later captures: the
        graphs captured into the old one go with the cache, and a pool
        whose graphs were all released takes no new capture (PyTorch's
        caching host allocator keeps the released pool's id and fails an
        internal assert when a capture names it again)."""
        super().clear_cache()
        with self._lock:
            self._graph_pool = None

    def _key_opts(self):
        # an entry's graph and a record's timings belong to one product:
        # "cuda:0" names a slot, not the card in it
        return {**self.backend_opts,
                "device_name": diskcache.device_name(self.device)}

    def _codegen(self, fn: Function, options: CompileOptions
                 ) -> Tuple[Callable, Optional[Callable], Optional[Callable]]:
        def ctx_for(device):
            return EmitCtx(device, use_pallas=options.use_pallas,
                           attn_impl=options.attn_impl,
                           attn_chunk=options.attn_chunk, mode=options.mode)

        dev = self.device
        mesh = self._shardmap_mesh(fn, options)
        if mesh is None:
            run = emit_callable(fn, ctx_for(dev), pair_donations(
                fn.in_types, fn.out_types, options.donate_argnums))
            in_types, out_types = fn.in_types, fn.out_types
            one_stream = True
        else:
            sole = is_meta(mesh)
            home = torch.device("meta") if sole else dev
            run = ShardedProgram(fn, mesh, ctx_for, home=home,
                                 sole_shard=sole)
            in_types, out_types = run.in_types, run.out_types
            one_stream = all(d == dev for d in run.layout.devices)
        if dev.type == "cuda" and options.static_jit and one_stream:
            with self._lock:
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                    self._capture_stream = torch.cuda.Stream(dev)
            run = GraphedProgram(
                run, name=fn.name, device=dev, in_types=in_types,
                out_types=out_types,
                donate_argnums=options.donate_argnums,
                pool=self._graph_pool, stream=self._capture_stream)
        else:
            run.donation = pair_donations(in_types, out_types,
                                          options.donate_argnums)

        def call(*args):
            outs = run(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return [o if o.is_meta else to_numpy(o) for o in outs]

        return call, run, None

    def _shardmap_mesh(self, fn: Function, options: CompileOptions):
        """The mesh to run a partitioned graph over, or None.

        Active only when the PartitionGraph pass actually ran (parameters
        carry ``pspec`` attrs): plain ``mode='shardmap'`` compiles with
        hand-written collectives are left alone (run them through
        :func:`.sharded.shard_map`).  A pjit mesh is folded
        (:func:`.sharding.fold_pods`), as the pass saw it."""
        if options.mode == "pjit":
            return fold_pods(options.mesh)
        if options.mode != "shardmap":
            return None
        if not any("pspec" in p.attrs for p in fn.parameters):
            return None
        return mesh_for_options(options, self.device)
