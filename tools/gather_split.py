#!/usr/bin/env python3
"""Where the time of the ``sdc_gather_topk`` scan goes, measured by kernel variants.

    python3 tools/gather_split.py [--tree .] [--seed 0] [--docs 10000037] [--reps 10]

Run on a CUDA card from the root of a checkout; ``--tree`` names the
checkout whose ``src/repro_torch`` is measured (another commit unpacked
beside this one, for example). It builds the IVF index that
``chip_smoke.py`` serves (10,000,037 clustered documents, dim 256 ->
code_dim 128 at n_levels 4, nlist 64, 20 k-means iterations, seed 1),
takes the probes of its first request of 64 queries (nprobe 32, and the
probe budget 2,080 with its candidate mask), then compiles variants of
the tree's ``gather_topk.cu`` in which one part is cut out by text
substitution and times each with CUDA events in the int8, packed and
masked forms:

  full         the kernel as it is
  no-product   the tile product skipped, its dot tile filled with one XOR
               of a row word and a query word
  no-selector  every key computed, none inserted; each selector round is
               one barrier
  warm-up      the selector runs on each block's first live round only
  neither      no product and no selector

A variant's results are wrong by design; only its time is read. The
split follows: product = full - no-product, selector = full -
no-selector, first-round selector work = warm-up - no-selector. Each
time is the whole call (wrapper, scan and merge kernels); ``full`` is
timed first and last to show drift, and a profiler pass gives the scan
and merge kernels' own times where the profiler sees the card.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

from split_common import build_variants, card, profiled_kernels, register_lines, time_ms

ROOT = Path(__file__).resolve().parents[1]
SERVE_Q, N_QUERIES, K = 64, 512, 10
DIM, CODE_DIM, LEVELS = 256, 128, 4
PROBE_BUDGET = 2080

# Each cut is a list of edits (pattern, replacement); each pattern must be
# found in the source.
_INSERT_AT = "for (int j = 0; j < np; ++j) sel.insert(j, key_of(j));"
_END_AT = "\n      sel.end_round(np, key_of);\n"
_INSERT = [(_INSERT_AT,
            "for (int j = 0; j < np; ++j) { if (key_of(j) == 1ull) sel.count[j] = -1; }")]
_END_ROUND = [(_END_AT, "\n      __syncthreads();\n")]
_NO_PRODUCT = [("tile_dots<D, PACKED>(tile, qs, dots, np);",
                "for (int j = 0; j < np; ++j) dots[j * kDotStride + threadIdx.x] = "
                "(int)(tile[threadIdx.x * T::S] ^ (unsigned)qs[j * T::QS]);")]
# `warm` is true through a block's first live round.
_WARM_UP = [(_INSERT_AT, "for (int j = 0; j < np; ++j) { if (warm) sel.insert(j, key_of(j)); "
                         "else if (key_of(j) == 1ull) sel.count[j] = -1; }"),
            (_END_AT, "\n      if (warm) sel.end_round(np, key_of); else __syncthreads();\n")]
VARIANTS = {
    "full": [],
    "no-product": _NO_PRODUCT,
    "no-selector": _INSERT + _END_ROUND,
    "warm-up": _WARM_UP,
    "neither": _NO_PRODUCT + _INSERT + _END_ROUND,
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=10_000_037)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--pairs", default="",
                    help="comma-separated pairs per scan block to time the full kernel at, "
                         "besides the wrapper's own choice")
    ap.add_argument("--waves", default="",
                    help="comma-separated grid depths (the wrapper's _WAVES) for that sweep")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gather_split: no CUDA device")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch import prng
    from repro_torch.core.binarize_lib import BinarizerConfig, init_binarizer, make_encode_fn
    from repro_torch.data.synthetic import clustered_corpus_torch
    from repro_torch.index import ivf
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdc import gather
    from repro_torch.launch.serve import encode_codes
    try:
        from repro_torch.launch.serve import cli_builder
    except ImportError:  # a tree from before the CLI built through lifecycle builders
        from repro_torch.launch.serve import IVF_KMEANS_ITERS, IVF_NLIST, IVF_NPROBE, IVF_SEED
    else:
        p = cli_builder("ivf").params
        IVF_NLIST, IVF_NPROBE, IVF_SEED, IVF_KMEANS_ITERS = (p["nlist"], p["nprobe"], p["seed"],
                                                             p["kmeans_iters"])

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"[split] tree {tree} on {smi}", flush=True)

    # -- variants of the kernel source, built together ---------------------
    sources = build_variants(_build.build, Path(gather._SOURCE), VARIANTS,
                             _build.BUILD_DIR / "gather_split", "gather_split")
    for name, src in sources.items():
        for kernel, line in register_lines(_build.library_path(src).with_suffix(".log"),
                                           r"gather_scan_kernelILi128E"):
            m = re.search(r"ILi128ELb([01])ELb([01])E", kernel)
            print(f"[split] build {name}: gather_scan_kernel D=128 packed={m.group(1)} "
                  f"masked={m.group(2)}: {line}")

    # -- the serving shapes of chip_smoke.py -------------------------------
    docs, queries, _ = clustered_corpus_torch(args.seed, args.docs, N_QUERIES, DIM, device=device)
    bcfg = BinarizerConfig(input_dim=DIM, code_dim=CODE_DIM, n_levels=LEVELS, hidden_dim=2 * DIM)
    model = init_binarizer(bcfg, prng.key(args.seed, device), device)
    d_codes = encode_codes(model, docs, batch=1 << 17)
    del docs
    q = make_encode_fn(model)(queries[:SERVE_Q])
    indexes = {p: ivf.build_ivf(d_codes, n_levels=LEVELS, nlist=IVF_NLIST,
                                kmeans_iters=IVF_KMEANS_ITERS, seed=IVF_SEED, packed=p,
                                device=device) for p in (False, True)}
    calls = {}
    for tag, packed, budget in (("int8", False, None), ("packed", True, None),
                                ("masked", False, PROBE_BUDGET)):
        index = indexes[packed]
        L = index.lists_ids.shape[1]
        mask = None
        if budget:
            r = ivf.probe_rank_thresholds(index.list_occupancy, probe_budget=budget,
                                          nlist=index.nlist)
            probes = ivf.coarse_probes(q, index.centroids, index.centroid_codes,
                                       nprobe=int(r.max()), n_levels=LEVELS)
            cols = torch.arange(probes.shape[1], device=device)
            live = cols[None, :] < torch.as_tensor(r, device=device)[probes.long()]
            mask = live[:, :, None].float().expand(-1, -1, L)
        else:
            probes = ivf.coarse_probes(q, index.centroids, index.centroid_codes,
                                       nprobe=IVF_NPROBE, n_levels=LEVELS)
        calls[tag] = ((q, index.lists_codes, index.lists_inv_norm, index.lists_ids, probes),
                      dict(n_levels=LEVELS, k=K, packed=packed, cand_mask=mask))
    del d_codes
    torch.cuda.synchronize()

    def use(name):
        gather._SOURCE = sources[name]
        gather._lib.cache_clear()

    def call_ms(tag):
        a, kw = calls[tag]
        return time_ms(lambda: gather.sdc_gather_topk(*a, **kw), args.reps)

    order = list(VARIANTS) + ["full"]
    times = {}
    for i, name in enumerate(order):
        use(name)
        key = name if i < len(VARIANTS) else "full again"
        times[key] = {tag: call_ms(tag) for tag in calls}
        print(f"[split] {key:12s} " + "  ".join(f"{t} {ms:.3f} ms" for t, ms in times[key].items()),
              flush=True)
    for tag in calls:
        f = times["full"][tag]
        print(f"[split] {tag}: full {f:.3f} ms; product {f - times['no-product'][tag]:.3f}, "
              f"selector {f - times['no-selector'][tag]:.3f} (first live round "
              f"{times['warm-up'][tag] - times['no-selector'][tag]:.3f}), rest "
              f"{times['neither'][tag]:.3f} ms on {smi}")

    # -- the full kernel at other numbers of pairs per block ----------------
    use("full")
    choose = gather._pairs_per_block
    waves0 = gather._WAVES
    for waves in [int(x) for x in args.waves.split(",") if x] or [waves0]:
        gather._WAVES = waves
        for qc in [int(x) for x in args.pairs.split(",") if x]:
            gather._pairs_per_block = lambda D, packed, cap, qc=qc: qc
            t = {tag: call_ms(tag) for tag in calls}
            print(f"[split] full, {qc} pairs a block, {waves} waves: "
                  + "  ".join(f"{tag} {ms:.3f} ms" for tag, ms in t.items()), flush=True)
    gather._WAVES = waves0
    gather._pairs_per_block = choose
    print(f"[split] the wrapper's choice at D={CODE_DIM}, k={K}: "
          f"{choose(CODE_DIM, False, gather.cap_for(K))} pairs a block int8, "
          f"{choose(CODE_DIM, True, gather.cap_for(K))} packed", flush=True)

    # -- the scan and merge kernels alone, where the profiler sees them ----
    for tag in calls:
        a, kw = calls[tag]
        rows = profiled_kernels(lambda: gather.sdc_gather_topk(*a, **kw), args.reps,
                                r"gather_\w+_kernel")
        print(f"[split] profiler {tag}: {rows}", flush=True)


if __name__ == "__main__":
    main()
