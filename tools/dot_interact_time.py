#!/usr/bin/env python3
"""Where a ``dot_interact`` call's time goes at dlrm-rm2's serving batches: host or card.

    python3 tools/dot_interact_time.py [--tree .] [--calls 2000]

Run on a CUDA card from the root of a checkout; ``--tree`` names the
checkout whose ``src/repro_torch`` is measured (another commit unpacked
beside this one, for example). For seeded inputs of dlrm-rm2's shape
(F = 27, D = 64) at B = 512 and 262,144 it prints, per call: the host
time to issue it (``--calls`` calls back to back, then one
synchronisation, on the host clock), the CUDA-event time over the same
back-to-back calls, and the kernel's device time by ``torch.profiler``.
Where the issue time exceeds the device time, the host's launch path,
not the kernel, sets the time of back-to-back calls.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from split_common import card, profiled_kernels, time_ms

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((512, 27, 64), (262_144, 27, 64))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dot_interact_time: no CUDA device")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.dot_interact import kernel as di

    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(0)
    smi = card()
    for B, F, D in SHAPES:
        e = torch.randn((B, F, D), generator=gen, device=device)
        calls = args.calls if B <= 4096 else 20
        di.dot_interact(e)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            di.dot_interact(e)
        issue_us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        event_ms = time_ms(lambda: di.dot_interact(e), calls)
        dev_time = profiled_kernels(lambda: di.dot_interact(e), min(calls, 50),
                                    r"dot_interact_kernel")
        print(f"[dot] tree {tree.name} B={B} F={F} D={D}: issue {issue_us:.1f} us a call, "
              f"CUDA events {event_ms:.4f} ms, device {dev_time} on {smi}", flush=True)


if __name__ == "__main__":
    main()
