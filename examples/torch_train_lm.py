"""End-to-end LM training on torch on the synthetic pipeline: a reduced
llama-family model for a few hundred steps, with checkpointing and the
fault-tolerance hooks (the counterpart of ``examples/train_lm.py``, a
thin wrapper over ``repro_torch.launch.train``).

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] [--steps 300]

Runs on the card unless ``--device cpu``.  Checkpoints go to
``build/torch_train_lm`` in the checkout (a run there resumes from the
last one); ``--ckpt-dir DIR`` puts them elsewhere.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.launch.train import main  # noqa: E402

if __name__ == "__main__":
    args = sys.argv[1:]
    if not any(a.startswith("--steps") for a in args):
        args += ["--steps", "300"]
    # the deepseek-7b family at its reduced width and depth; a flag in
    # argv comes later and wins
    sys.exit(main([
        "--arch", "deepseek-7b", "--reduced",
        "--batch", "16", "--seq", "128",
        "--ckpt-dir", os.path.join(REPO, "build", "torch_train_lm"),
        "--ckpt-every", "100", "--log-every", "20",
    ] + args))
