"""Batched serving on torch: prefill + greedy decode through KV caches
(the counterpart of ``examples/serve_lm.py``, a thin wrapper over
``repro_torch.launch.serve``).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu] [--arch ...]

Runs on the card unless ``--device cpu``.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(["--arch", "deepseek-7b", "--reduced", "--batch", "4",
                   "--prompt-len", "32", "--gen", "32"] + sys.argv[1:]))
