"""repro_torch: the nGraph reproduction's IR, pass pipeline and paged
serving engine on PyTorch and CUDA (NVIDIA H100), beside the JAX package
``repro``, which stays the frozen reference.

The IR layers (``core``, ``configs``, ``models``) are the reference's own
numpy code, copied; code generation (``transformers.torch_emit``), the
backend (``backend.torch_backend``), the kernels (``kernels``: CUDA C++
for sm_90a) and the serving engine (``launch.engine``) are ported.  This
package imports torch and numpy, never jax and nothing of ``repro``.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), and raise when no card is present: there is no
silent fallback.
"""
import torch

# the reference's f32 tolerances assume true f32 products and convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core import ops as ng  # noqa: E402,F401
from .core import Function, Node, TensorType, Value  # noqa: E402,F401

__version__ = "1.1.0"
