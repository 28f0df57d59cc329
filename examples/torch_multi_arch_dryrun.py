"""Compile any assigned architecture on the production H100 mesh and
print its roofline terms (the counterpart of
``examples/multi_arch_dryrun.py``, a thin wrapper over
``repro_torch.launch.dryrun``).

    PYTHONPATH=src python examples/torch_multi_arch_dryrun.py --arch xlstm-350m --shape train_4k

The dry run compiles and walks the plan on meta devices, so it needs no
card; ``--device cpu`` is accepted, as every example takes it, and
changes nothing.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.dryrun import main  # noqa: E402

if __name__ == "__main__":
    args = sys.argv[1:]
    if "--device" in args:   # meta devices either way
        i = args.index("--device")
        del args[i:i + 2]
    sys.exit(main(args or ["--arch", "xlstm-350m", "--shape", "train_4k"]))
