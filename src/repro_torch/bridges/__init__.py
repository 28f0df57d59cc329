"""Framework bridges (paper sec. 3): adapters translating a framework's
computational graph into nGraph IR.  Here: a neon-style layer API and an
ONNX-like serialized-graph importer; the functional builder in
``repro_torch.core.ops`` plays the role of the native Python binding.
A copy of the reference's ``bridges`` package; ``neon.compile_model``
compiles on the port's backends (``"torch"`` by default)."""
from .neon import (Dense, Embedding, LayerNormLayer, Model, RMSNormLayer,  # noqa: F401
                   Sequential, bridge_to_ir)
from . import onnx_like  # noqa: F401
