"""How many device records ``torch.profiler`` drops at the edges of its
window, with and without marker kernels around the profiled call.

Captures one CUDA graph of ``--kernels`` small elementwise kernels and
profiles its replay in a run of sessions in one process, alternately
bare and between ``--pad`` marker kernels a side (``torch.cuda._sleep(1)``,
``spin_kernel``), the way ``chip_smoke._profile`` takes its profiles.
For each session it prints the graph's kernels the profile shows (of
``--kernels``) and, when bracketed, the markers lost before and after
the call.  The last line is a JSON summary.

    python scripts/torch_profile_edges.py [--kernels 45000] [--sessions 10] [--pad 256]

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import torch

MARKER = re.compile(r"(?<![A-Za-z0-9_])spin_kernel(?![A-Za-z0-9_])")


def _graph(n_kernels: int):
    x = torch.randn(4096, device="cuda")
    y = torch.empty_like(x)
    ops = (lambda: torch.add(x, 1.0, out=y), lambda: torch.mul(y, 0.5, out=y),
           lambda: torch.neg(y, out=y))

    def body():
        for i in range(n_kernels):
            ops[i % 3]()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    g.replay()
    torch.cuda.synchronize()
    return g


def _session(g, pad: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1)
        g.replay()
        for _ in range(pad):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    evs = sorted((ev.time_range.start, bool(MARKER.search(ev.name)))
                 for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    work = [i for i, (_, m) in enumerate(evs) if not m]
    out = {"pad": pad, "seen": len(work)}
    if pad and work:
        out["markers_lost_before"] = pad - work[0]
        out["markers_lost_after"] = pad - (len(evs) - 1 - work[-1])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", type=int, default=45000)
    ap.add_argument("--sessions", type=int, default=10)
    ap.add_argument("--pad", type=int, default=256)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_edges: needs a CUDA card", file=sys.stderr)
        return 2
    g = _graph(a.kernels)
    rows = []
    for i in range(a.sessions):
        for pad in (0, a.pad):
            r = _session(g, pad)
            r["session"] = i
            rows.append(r)
            print("[edges]", json.dumps(r), flush=True)
    bare = [r for r in rows if r["pad"] == 0]
    padded = [r for r in rows if r["pad"]]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "kernels": a.kernels,
        "torch": torch.__version__, "pad": a.pad,
        "bare_sessions_short": sum(r["seen"] < a.kernels for r in bare),
        "bare_max_lost": max(a.kernels - r["seen"] for r in bare),
        "padded_sessions_short": sum(r["seen"] < a.kernels for r in padded),
        "padded_max_markers_lost": max(
            max(r.get("markers_lost_before", 0),
                r.get("markers_lost_after", 0)) for r in padded),
        "sessions": a.sessions}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
