#!/usr/bin/env python3
"""Issue rates of the tensor-core products ``binary_dot`` can be built on.

    python3 tools/mma_rate.py [--iters 4096] [--blocks-per-sm 4] [--reps 10]

Run on a CUDA card from the root of a checkout. It builds
``tools/csrc/mma_rate.cu``, checks the b1 fragment layout of
``mma.sync.m16n8k128`` and ``m16n8k256`` (``.and.popc``) against
popcounts computed on the host, then times register-only loops of three
``mma.sync`` products over one full grid with CUDA events and prints,
for each, products a second, products per SM and clock (at the SM clock
``nvidia-smi`` reports), bit or byte operations a second, and what the
product of ``binary_dot`` at the bitwise phase's shapes (Q 64, N
10,000,037, m 128, n_levels 4) would take at that rate alone:

  b1_k128  one Hamming term per plane pair: N/16 x Q/8 x n_levels^2 products
  b1_k256  two plane pairs of one weight in one product: 10 of them a
           (16 x 8) tile at n_levels 4 instead of 16
  s8_k32   one int8 product over the level values X = 2c - (2^L - 1):
           N/16 x Q/8 x m/32 products
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "csrc" / "mma_rate.cu"
Q, N, M, LEVELS = 64, 10_000_037, 128, 4
# name: (kind, bit or byte multiply-adds a product, products a 16 x 8 tile of binary_dot)
KINDS = {"b1_k128": (0, 16 * 8 * 128, LEVELS**2), "b1_k256": (1, 16 * 8 * 256, 10),
         "s8_k32": (2, 16 * 8 * 32, M // 32)}


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--blocks-per-sm", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    lib = _build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mma_rate_launch.argtypes = [I, I, I, I, P, P]
    lib.mma_layout_launch.argtypes = [P, P, I, P, P]
    for f in (lib.mma_rate_launch, lib.mma_layout_launch, lib.mma_rate_chains):
        f.restype = I
    for line in _build.library_path(SOURCE).with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("[ptxas]", line.replace("ptxas info    :", "").strip())
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    rng = np.random.default_rng(0)
    for words in (4, 8):
        a = rng.integers(0, 2**32, (16, words), dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, 2**32, (8, words), dtype=np.uint64).astype(np.uint32)
        a[3] = 0xFFFFFFFF  # extreme rows: all ones and all zeros
        a[5] = 0
        want = np.array([[sum(bin(int(x) & int(y)).count("1") for x, y in zip(a[i], b[j]))
                          for j in range(8)] for i in range(16)])
        ta = torch.from_numpy(a.view(np.int32)).to(dev)
        tb = torch.from_numpy(b.view(np.int32)).to(dev)
        tc = torch.zeros((16, 8), dtype=torch.int32, device=dev)
        err = lib.mma_layout_launch(ta.data_ptr(), tb.data_ptr(), words, tc.data_ptr(), stream)
        torch.cuda.synchronize()
        ok = err == 0 and np.array_equal(tc.cpu().numpy(), want)
        print(f"[layout] b1 k{32 * words} and.popc: {'equal' if ok else 'DIFFERS'} to host popcounts")
        if not ok:
            return 1

    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    blocks, threads = sms * args.blocks_per_sm, 256
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    chains = lib.mma_rate_chains()
    products = blocks * (threads // 32) * args.iters * chains
    card = smi("name,power.limit")
    tiles = N / 16 * Q / 8
    for name, (kind, macs, per_tile) in KINDS.items():
        def run():
            err = lib.mma_rate_launch(kind, blocks, threads, args.iters, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"mma_rate launch failed: CUDA error {err}")
        run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        rate = products / (ms * 1e-3)
        per_sm_clock = rate / sms / (clock_mhz * 1e6)
        print(f"[rate] {name} on {card} ({sms} SMs, {clock_mhz:.0f} MHz max): {ms:.4f} ms for "
              f"{products:.3e} products, {rate:.4e}/s, {per_sm_clock:.4f} per SM per clock, "
              f"{2 * macs * rate / 1e12:.1f} T{'bit ' if kind < 2 else ''}ops/s; binary_dot's "
              f"product at Q {Q} N {N} m {M} n_levels {LEVELS}: {per_tile} a tile, "
              f"{tiles * per_tile:.3e} products, {1e3 * tiles * per_tile / rate:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
