"""Model parameters as device tensors.

``params_from_numpy`` carries the JAX package's (numpy) parameters
across, so a test compares the two packages on the same weights.
``init_params_on_device`` draws each parameter on the device with one
seeded ``torch.Generator``, through the builder's own initializers
(``models/builder.py``: normal, fan-in, zeros, ones), so the
distributions are the reference's while the numbers are torch's.  It is
the full-width path: a numpy init of deepseek-7b's 27.6 GB of f32
weights on the host would take minutes and then cross the bus.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..devices import as_tensor, resolve_device, torch_dtype
from .builder import ModelBuilder


def params_from_numpy(params: Mapping[str, Any],
                      device: Any) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {n: as_tensor(v, dev) for n, v in params.items()}


class _Draw:
    """The value a builder initializer computes from ``rng.normal``: a
    device tensor behind the numpy operators the initializers use."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __mul__(self, s):
        return _Draw(self.t.mul_(float(s)))

    def __truediv__(self, s):
        return _Draw(self.t.div_(float(s)))

    def astype(self, dtype) -> torch.Tensor:
        return self.t.to(torch_dtype(dtype))


class _DeviceRng:
    """``np.random.Generator``'s ``normal(size=...)`` on a device."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen = gen
        self.device = device

    def normal(self, size=None):
        return _Draw(torch.randn(tuple(size), generator=self.gen,
                                 device=self.device))


def init_params_on_device(builder: ModelBuilder, seed: int,
                          device: Any) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    rng = _DeviceRng(gen, dev)
    out: Dict[str, torch.Tensor] = {}
    for spec in builder.params.values():
        v = spec.init(rng, spec.shape, spec.dtype)
        out[spec.name] = v if isinstance(v, torch.Tensor) \
            else as_tensor(v, dev)
    return out
