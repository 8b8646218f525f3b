#!/usr/bin/env python3
"""Where the time of the device-resident bi-granular rerank goes, in two layouts.

    python3 tools/rerank_split.py [--tree .] [--seed 0] [--docs 10000037] [--reps 20]
        [--k-coarse 40,160,1000] [--groups 1,4,16,64]

Run on a CUDA card from the root of a checkout; ``--tree`` names the
checkout whose ``src/repro_torch`` is measured. It makes seeded random
codes at the ``chip_smoke.py`` shapes (N documents x code_dim 128 at
n_levels 4, 64 queries), takes each query's top-k' survivors of the
packed coarse scan at 2 levels (``BiGranularFlat``), and times the
rerank of those survivors on the full-level codes, which stay on the
card, in two layouts of the same gather kernel:

  one-row    ``rerank.sdc_rerank``: the corpus as N lists of one row, the
             sorted survivors as probes, a mask for the empty slots
  grouped g  the survivors' rows gathered on the card (``index_select``)
             into [Q * k' / g, g] lists with an identity probe table, the
             layout ``rerank.sdc_rerank_gathered`` uploads from the host

Each line gives the whole call by CUDA events, its parts (the layout and
the grouping of pairs by list, ``gather.gather_plan``, by CUDA events;
the scan and merge kernels by the profiler, where it sees the card) and
the byte bound; every layout's result is checked equal to the one-row
layout's.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from split_common import card, profiled_kernels, time_ms

ROOT = Path(__file__).resolve().parents[1]
SERVE_Q, K, CODE_DIM, LEVELS, COARSE = 64, 10, 128, 4, 2
HBM_BYTES_PER_S = 3.35e12


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=10_000_037)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--k-coarse", default="40,160,1000")
    ap.add_argument("--groups", default="1,4,16,64")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree) / "src"))

    import torch

    from repro_torch.core.binarize_lib import coarse_codes
    from repro_torch.index.flat import BiGranularFlat
    from repro_torch.kernels.sdc import gather
    from repro_torch.kernels.sdc import rerank
    from repro_torch.kernels.sdc import sdc

    if not torch.cuda.is_available():
        raise SystemExit("rerank_split.py runs only on a CUDA card")
    dev = torch.device("cuda")
    smi = card()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    N = args.docs
    codes = torch.randint(0, 2**LEVELS, (N, CODE_DIM), generator=gen, device=dev)
    codes = codes.to(torch.int8)
    q = torch.randint(0, 2**LEVELS, (SERVE_Q, CODE_DIM), generator=gen, device=dev)
    q = q.to(torch.int8)
    bigr = BiGranularFlat.build(codes, LEVELS, coarse_levels=COARSE, k_coarse=1, packed=True,
                                device=dev)
    fine, inv = bigr.fine_codes, bigr.fine_inv_norm
    qc = coarse_codes(q, LEVELS, COARSE)
    kw = dict(n_levels=LEVELS, k=K)
    cap_pairs = gather._pairs_per_block(sdc.kernel_dim(CODE_DIM), False, sdc.cap_for(K))
    print(f"[rerank-split] {smi}; N={N} Q={SERVE_Q} D={CODE_DIM} k={K}, survivors of the "
          f"packed coarse scan at {COARSE} levels", flush=True)

    def grouped(cand, g):
        c = rerank._sort_candidates(cand)
        Q, kp = c.shape
        g = min(g, kp)
        pad = (-kp) % g
        if pad:
            c = torch.cat([c, c.new_full((Q, pad), -1)], 1)
            kp += pad
        safe = c.clamp(0, N - 1).reshape(-1).to(torch.int64)
        n_lists = Q * kp // g
        return (fine.index_select(0, safe).reshape(n_lists, g, CODE_DIM),
                torch.where(c.reshape(-1) >= 0, inv[safe], 0.0).reshape(n_lists, g),
                c.reshape(n_lists, g),
                torch.arange(n_lists, dtype=torch.int32, device=dev).reshape(Q, kp // g))

    for kc in (int(x) for x in args.k_coarse.split(",")):
        _, cand = bigr.coarse.search(qc, kc)
        P = cand.numel()
        nbytes = P * (CODE_DIM + 8) + q.numel() + 4 * P + SERVE_Q * K * 8
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        want = rerank.sdc_rerank(q, fine, inv, cand, **kw)

        def one_row():
            return rerank.sdc_rerank(q, fine, inv, cand, **kw)

        def one_row_layout():
            return rerank._one_row_lists(fine, inv, cand)

        probes = rerank._sort_candidates(cand)
        whole = time_ms(one_row, args.reps)
        layout = time_ms(one_row_layout, args.reps)
        plan = time_ms(lambda: gather.gather_plan(probes, N, min(P, cap_pairs)), args.reps)
        kernels = profiled_kernels(one_row, args.reps, r"gather_(scan|merge)_kernel")
        print(f"[rerank-split] k'={kc} one-row: whole {whole:.4f} ms; layout (arange over N, "
              f"mask) {layout:.4f} ms, plan over {N} lists {plan:.4f} ms, {kernels}; "
              f"bound {bound:.4f} ms ({nbytes / 1e6:.3f} MB)", flush=True)
        for g in (int(x) for x in args.groups.split(",")):
            lists = grouped(cand, g)
            got = gather.sdc_gather_topk(q, *lists, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"rerank_split: grouped g={g} k'={kc} != one-row")

            def call(g=g):
                return gather.sdc_gather_topk(q, *grouped(cand, g), **kw)

            whole = time_ms(call, args.reps)
            layout = time_ms(lambda g=g: grouped(cand, g), args.reps)
            n_lists = lists[0].shape[0]
            Pg = lists[3].numel()
            plan = time_ms(lambda: gather.gather_plan(lists[3], n_lists, min(Pg, cap_pairs)),
                           args.reps)
            kernels = profiled_kernels(call, args.reps, r"gather_(scan|merge)_kernel")
            print(f"[rerank-split] k'={kc} grouped g={g}: whole {whole:.4f} ms; layout "
                  f"(index_select of the survivors) {layout:.4f} ms, plan over {n_lists} lists "
                  f"{plan:.4f} ms, {kernels}; equal to one-row", flush=True)


if __name__ == "__main__":
    main()
