#!/usr/bin/env python3
"""``binary_dot``'s time at the bitwise phase's shapes, for one tree or several in turns.

    python3 tools/binary_dot_time.py [--tree DIR ...] [--reps 5] [--levels 1,2,4]

Run on a CUDA card from the root of a checkout. Each ``--tree`` (default:
this checkout) names a checkout whose ``src/repro_torch`` is measured, in
a process of its own, in the order given: name the parent and this tree
as ``--tree parent --tree . --tree . --tree parent`` to compare them in
turns on one card. For each n_levels it makes seeded codes on the card at
Q = 64, N = 10,000,037, m = 128 (the serving batch and the chip_smoke
corpus; the work does not depend on the codes' values), packs their bit
planes, checks the kernel's [Q, N] scores against the plain version
exactly, and times the kernel with CUDA events over ``--reps`` calls.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from split_common import card, time_ms

ROOT = Path(__file__).resolve().parents[1]
Q, N, M = 64, 10_000_037, 128


def measure(tree: Path, levels, reps: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("binary_dot_time: no CUDA device")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.binarize_lib import pack_code_planes
    from repro_torch.kernels.binary_dot.kernel import binary_dot
    from repro_torch.kernels.binary_dot.ref import binary_dot_ref

    dev = torch.device("cuda:0")
    smi = card()
    for L in levels:
        gen = torch.Generator(device=dev).manual_seed(L)
        cq = torch.randint(0, 2**L, (Q, M), generator=gen, device=dev, dtype=torch.int8)
        cd = torch.randint(0, 2**L, (N, M), generator=gen, device=dev, dtype=torch.int8)
        pq, pd = pack_code_planes(cq, L), pack_code_planes(cd, L)
        del cd
        equal = torch.equal(binary_dot(pq, pd, m=M), binary_dot_ref(pq, pd, M))
        ms = time_ms(lambda: binary_dot(pq, pd, m=M), reps)
        print(f"[binary_dot] tree {tree.name} n_levels={L} Q={Q} N={N} m={M}: {ms:.4f} ms "
              f"({reps} calls, CUDA events), equal to the plain version: {equal}, on {smi}",
              flush=True)
        if not equal:
            raise SystemExit("binary_dot_time: the kernel differs from the plain version")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--levels", default="1,2,4")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the per-tree child process
    args = ap.parse_args()
    levels = [int(x) for x in args.levels.split(",")]
    if args.one:
        measure(Path(args.one).resolve(), levels, args.reps)
        return
    for tree in args.tree or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree, "--reps", str(args.reps),
                        "--levels", args.levels], check=True)


if __name__ == "__main__":
    main()
