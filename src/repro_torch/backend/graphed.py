"""CUDA-graph capture of an emitted program: the torch port's ``jax.jit``.

``CompileOptions(static_jit=True)`` (the default) on a CUDA device wraps
the emitted program in a :class:`GraphedProgram`.  The IR is static, so
one compiled function has one set of shapes:

- call 1 runs the program eagerly.  It is also the warm-up capture
  needs: the kernels' one-time ``cudaFuncSetAttribute`` statics and
  cuBLAS's handles are set up outside the capture;
- every later call replays a graph captured over the device tensors it
  is given.  Graphs are keyed by those tensors' addresses and strides:
  the first call with a new set captures one (a server's weights and KV
  pool keep theirs for the engine's life, so it captures once), and a
  call with a known set replays it.

The replay contract:

- *Host arguments* (numpy arrays, scalars) are copied into the graph's
  static device buffers before each replay; a copy from pageable host
  memory is not allowed while a stream captures.  A buffer takes its
  argument's element type, as the eager call reads it: the trainer's
  f32 frames for a bf16 ``frames`` input are f32 in every call, and a
  call with host arguments of other types captures another graph, as
  ``jax.jit`` traces again for new argument types.
- *Device tensors* are bound by address: the graph reads the caller's
  own tensors and is replayed only for tensors at those addresses.  It
  writes to no input that was not donated, and holds no reference to an
  input: a freed tensor's address comes back in a key only as another
  live tensor of the same shape, strides and dtype, which the graph then
  reads.
- *Donated inputs* on the card are written back in place, on the eager
  first call as in the capture (which ends with ``inp.copy_(out)``): the
  output returned is the input tensor itself, so a donated buffer keeps
  one identity for its owner's life and every graph that reads it binds
  the same tensor.  Outputs pair with donated inputs as XLA pairs them:
  in order, by shape and dtype (:func:`pair_donations`).  A donated host
  argument is not written back.
- *Other outputs* are cloned out of the graph's memory before they are
  returned, so a later replay never changes a tensor a caller holds.
- *Launch counts*: a replay does not pass through the kernel wrappers,
  so the capture records each kernel's counter delta and every replay
  adds it (:func:`repro_torch.kernels.add_counts`).

All graphs of one backend share one memory pool.  PyTorch allows that
when no two of the graphs run at once: here every replay is enqueued on
the caller's current stream by the one thread that calls the backend
(the engine thread), so replays are ordered on the card, and each
graph's intermediates are dead when it ends.  A graph's static outputs
stay referenced for its life, so no later capture reuses their memory.
A function keeps at most :data:`MAX_GRAPHS` graphs and drops the one
used longest ago (a process that builds engine after engine, as the
tests do, would otherwise keep a graph for each).

There is no fallback.  A capture that fails (an op that synchronises,
or copies host memory, while the stream captures) raises
:class:`GraphCaptureError` naming the graph and the op, and every later
call of that function raises it again; ``static_jit=False`` is the only
way to run eagerly on the card.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..core.types import TensorType
from ..devices import as_tensor, torch_dtype

MAX_GRAPHS = 8


class GraphCaptureError(RuntimeError):
    """A CUDA-graph capture of a compiled function failed."""


def pair_donations(in_types: Sequence[TensorType],
                   out_types: Sequence[TensorType],
                   donate_argnums: Sequence[int]) -> Dict[int, int]:
    """``{donated input index: output index}``, as XLA pairs donated
    buffers with outputs: each donated input, in order, takes the first
    output not yet taken with its shape and dtype.  A donated input no
    output matches is not written back."""
    pairs: Dict[int, int] = {}
    taken = set()
    for i in sorted(donate_argnums):
        t = in_types[i]
        for j, o in enumerate(out_types):
            if j not in taken and tuple(o.shape) == tuple(t.shape) \
                    and o.dtype == t.dtype:
                pairs[i] = j
                taken.add(j)
                break
    return pairs


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same tensor for the graph: address, shape, strides, dtype."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def _where(exc: BaseException) -> str:
    notes = getattr(exc, "__notes__", None)
    return "; ".join(notes) if notes else "outside the emitted ops"


def write_back(inputs: Sequence[Any], outs: List[torch.Tensor],
               pairs: Dict[int, int]) -> List[torch.Tensor]:
    """Copy each output of ``pairs`` (``{input: output}``) into its
    donated input and put the input in its place.  An output that shares
    memory with a donated input (other than as that input itself) is
    cloned first, so no copy reads a buffer another copy wrote."""
    owner = {j: i for i, j in pairs.items()}
    donated = {_storage(inputs[i]) for i in pairs}
    for j, o in enumerate(outs):
        if _storage(o) in donated and not (
                j in owner and _same(o, inputs[owner[j]])):
            outs[j] = o.clone()
    for i, j in pairs.items():
        if not _same(outs[j], inputs[i]):
            inputs[i].copy_(outs[j])
        outs[j] = inputs[i]
    return outs


class _Graph:
    """One capture: the graph, the static buffers of its host arguments,
    its outputs (None where it returns a donated input; ``returns`` maps
    such an output to its input) and the kernel counter delta of one
    replay."""

    def __init__(self, graph, buffers, outputs, returns, launches):
        self.graph = graph
        self.buffers: Dict[int, torch.Tensor] = buffers
        self.outputs: List[Optional[torch.Tensor]] = outputs
        self.returns: Dict[int, int] = returns
        self.launches: Dict[str, Dict[str, int]] = launches


class GraphedProgram:
    """An emitted program run eagerly once, then captured for each set of
    device-argument addresses and replayed (see the module docstring).
    ``donation`` maps donated inputs to the outputs written back into
    them; ``launches`` holds the kernel counter delta of one replay of
    the newest capture."""

    def __init__(self, run: Callable, *, name: str, device: torch.device,
                 in_types: Sequence[TensorType],
                 out_types: Sequence[TensorType],
                 donate_argnums: Sequence[int], pool, stream):
        self._run = run
        self.name = name
        self.device = device
        self.in_shapes = [tuple(t.shape) for t in in_types]
        self.in_dtypes = [torch_dtype(t.dtype) for t in in_types]
        self.donation = pair_donations(in_types, out_types, donate_argnums)
        self._pool = pool
        self._stream = stream
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.launches: Optional[Dict[str, Dict[str, int]]] = None
        self._graphs: "OrderedDict[Tuple, _Graph]" = OrderedDict()
        self._failed: Optional[BaseException] = None

    @property
    def captured(self) -> bool:
        return bool(self._graphs)

    @property
    def graphs(self) -> int:
        """How many captured graphs this function holds."""
        return len(self._graphs)

    def __call__(self, *args):
        if len(args) != len(self.in_shapes):
            raise TypeError(f"{self.name}: expected {len(self.in_shapes)} "
                            f"args, got {len(args)}")
        if self._failed is not None:
            raise GraphCaptureError(
                f"graph {self.name}: its capture failed "
                f"({_where(self._failed)}): {self._failed}"
            ) from self._failed
        dev = self.device
        on_device = [i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor) and a.device == dev]
        for i in on_device:
            self._check(i, args[i])
        pairs = {i: j for i, j in self.donation.items() if i in on_device}
        self.calls += 1
        if self.calls == 1:
            return tuple(write_back(args, list(self._run(*args)), pairs))
        host = {i: self._host(i, a) for i, a in enumerate(args)
                if i not in on_device}
        key = tuple((i, args[i].data_ptr(), args[i].stride())
                    for i in on_device) + \
            tuple((i, t.dtype) for i, t in host.items())
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(args, host, pairs)
            self._graphs[key] = g
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        return self._replay(g, host, args)

    # -- arguments ------------------------------------------------------------
    def _host(self, i: int, a: Any) -> torch.Tensor:
        """Argument ``i`` as a CPU tensor of the parameter's shape, in its
        own element type."""
        t = as_tensor(a, torch.device("cpu"))
        self._check(i, t, dtype=False)
        return t

    def _check(self, i: int, t: torch.Tensor, dtype: bool = True) -> None:
        if tuple(t.shape) != self.in_shapes[i] or \
                (dtype and t.dtype != self.in_dtypes[i]):
            raise ValueError(
                f"graph {self.name}: argument {i} is {tuple(t.shape)} "
                f"{t.dtype}, the graph takes {self.in_shapes[i]} "
                f"{self.in_dtypes[i]}")

    # -- capture and replay ---------------------------------------------------
    def _capture(self, args, host: Dict[int, torch.Tensor],
                 pairs: Dict[int, int]) -> _Graph:
        dev = self.device
        inputs = list(args)
        buffers = {}
        for i, t in host.items():
            buffers[i] = inputs[i] = torch.empty(
                self.in_shapes[i], dtype=t.dtype, device=dev)
        # the cached blocks of earlier eager calls are released before
        # the graph's pool grows
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        # cuBLAS makes its handle per thread at first use and cannot do
        # so inside a capture (CUBLAS_STATUS_NOT_INITIALIZED): a thread
        # whose first call of this function is a capture -- a server's
        # engine thread serving graphs another thread ran first -- makes
        # it here, with the capture stream's workspace
        with torch.cuda.device(dev), torch.cuda.stream(self._stream):
            torch.cuda.current_blas_handle()
        graph = torch.cuda.CUDAGraph()
        before = kernels.counters()
        failure: Optional[BaseException] = None
        outs: List[torch.Tensor] = []
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool)
            try:
                outs = write_back(inputs, list(self._run(*inputs)), pairs)
            except Exception as exc:   # re-raised below, after capture_end
                failure = exc
            finally:
                try:
                    graph.capture_end()
                except RuntimeError as exc:
                    if failure is None:
                        failure = exc
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        if failure is not None:
            self._failed = failure
            raise GraphCaptureError(
                f"graph {self.name}: capture failed ({_where(failure)}): "
                f"{failure}") from failure
        # the capture enqueued nothing on the card: its launches are
        # counted when the replays run them
        self.launches = kernels.counter_delta(before, kernels.counters())
        kernels.set_counters(before)
        self.captures += 1
        returns = {j: i for i, j in pairs.items()}
        outputs = [None if j in returns else o for j, o in enumerate(outs)]
        return _Graph(graph, buffers, outputs, returns, self.launches)

    def _replay(self, g: _Graph, host: Dict[int, torch.Tensor], args):
        for i, buf in g.buffers.items():
            buf.copy_(host[i])
        g.graph.replay()
        self.replays += 1
        kernels.add_counts(g.launches)
        return tuple(args[g.returns[j]] if j in g.returns else o.clone()
                     for j, o in enumerate(g.outputs))
