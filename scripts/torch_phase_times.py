"""Run some phases of a checkout's ``chip_smoke.py`` on the card, without
phase 3's kernel cases: the device and build phases, then each phase
named, in order, with its usual gates and output lines ([train], [moe],
[train_family], ...).  Used to time two checkouts in one call on one
card, the parent's unpacked into a git-ignored directory:

    python scripts/torch_phase_times.py --root build/parent train moe train_families
    python scripts/torch_phase_times.py train moe train_families

Phase names are ``chip_smoke.py``'s functions without ``phase_``;
``train_family:<arch>`` runs one family of phase 15 (``_train_family``),
e.g. ``train_family:xlstm-350m``.  No result line is printed; the exit
code is non-zero if a phase failed.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout (default: this one)")
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs   # puts root/src first on sys.path
    from repro_torch import kernels
    print(f"[phase_times] root={root} chip_smoke={cs.__file__}", flush=True)
    smi = cs.phase_device()
    cs.phase_build()
    report = {name: {"name": name, "launches": 0, "launches_by_phase": {}}
              for name in kernels.MODULES}
    for name in args.phases:
        t0 = time.perf_counter()
        if name.startswith("train_family:"):
            cs._train_family(report, name.split(":", 1)[1], smi)
        else:
            getattr(cs, f"phase_{name}")(report, smi)
        print(f"[phase_times] phase={name} seconds="
              f"{time.perf_counter() - t0:.2f} card={smi!r}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
