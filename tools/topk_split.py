#!/usr/bin/env python3
"""Where the time of the ``sdc_topk`` flat scan goes, measured by kernel variants.

    python3 tools/topk_split.py [--tree .] [--seed 0] [--docs 10000037] [--reps 10]
                                [--variants full,...] [--extra] [--shapes 16,32,16x4]
                                [--batches 64,256,1024]

Run on a CUDA card from the root of a checkout; ``--tree`` names the
checkout whose ``src/repro_torch`` is measured (another commit unpacked
beside this one, for example). It encodes the corpus that
``chip_smoke.py`` serves (10,000,037 clustered documents, dim 256 ->
code_dim 128 at n_levels 4, seed 0) into the flat index, int8 and
packed, takes its first request of 64 queries (k = 10), then compiles
variants of the tree's ``sdc_topk.cu`` in which one part is cut out by
text substitution and times each whole call with CUDA events:

  full         the kernel as it is
  no-product   the tile product skipped, its dot tile filled with one XOR
               of a row word and a query word
  no-key       dots computed, but no epilogue and no key: one integer
               compare per (query, document) pair, and no selector
  no-selector  every key computed, none inserted; each selector round is
               one barrier
  warm-up      the selector runs on each block's first round only
  neither      no product and no selector

The split follows: product = full - no-product, selector = full -
no-selector, first-round selector work = warm-up - no-selector, keys =
no-selector - no-key. ``full`` is timed first and last to show drift.
Each variant's registers come from its build log, and the blocks per SM
and queries per block from the wrapper's own query of the library; a
profiler pass gives the scan and merge kernels' own times where the
profiler sees the card. ``--extra`` adds

  no-stage     no row staged (the norms still are): stale rows scored
  stage-only   the staging and barriers alone: no product, key or selector

``--shapes`` builds every variant again at each block shape named, with
the kernel's ``kMinBlocks`` edited and the wrapper's shape set to match:
16 (queries a block, three blocks an SM, the kernel's own), 32 (two
blocks an SM) and 16x4 (four). ``--batches`` times every variant at
other numbers of queries a call. The cuts are text edits of this
kernel's source; ``--variants full`` builds none, so it times any tree
(an earlier design of the kernel) at the same shapes.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from split_common import build_variants, card, profiled_kernels, register_lines, time_ms

ROOT = Path(__file__).resolve().parents[1]
SERVE_Q, N_QUERIES, K = 64, 512, 10
DIM, CODE_DIM, LEVELS = 256, 128, 4

# Each cut is a list of edits (pattern, replacement); each pattern must be
# found in the source.
_INSERT_AT = "const u64 key = key_of(j);\n          if (key > sel.thresh[j]) {"
_END_AT = "close_round(sel, nq, cut, !last, rescore);"
_NO_PRODUCT = [("tile_dots<D, PACKED>(tile, qs, dots, nq + 1);",
                "for (int j = 0; j < nq; ++j) dots[j * kDotStride + threadIdx.x] = "
                "(int)(tile[threadIdx.x * T::S] ^ (unsigned)qs[j * T::QS]);")]
_END_ROUND = [(_END_AT, "__syncthreads();")]
_NO_SELECTOR = [(_INSERT_AT, "const u64 key = key_of(j);\n          if (key == 1ull) {")] \
    + _END_ROUND
_NO_KEY = [(_INSERT_AT, "const u64 key = 0ull;\n          "
                        "if (dots[j * kDotStride + threadIdx.x] == 0x7fffffff) {")] + _END_ROUND
# `warm` is true through a block's first round.
_WARM_UP = [(_INSERT_AT, "const u64 key = key_of(j);\n          "
                         "if (warm ? key > sel.thresh[j] : key == 1ull) {"),
            (_END_AT, "if (warm) { " + _END_AT + " } else { __syncthreads(); }")]
VARIANTS = {
    "full": [],
    "no-product": _NO_PRODUCT,
    "no-key": _NO_KEY,
    "no-selector": _NO_SELECTOR,
    "warm-up": _WARM_UP,
    "neither": _NO_PRODUCT + _NO_SELECTOR,
}
# No row is staged (every round scores stale rows; the norms are still
# copied), or only the staging is left (no product, key or selector).
_NO_STAGE = [("    stage_rows<D, PACKED>(tile, docs + r * R::ROW_BYTES, "
              "__ballot_sync(0xFFFFFFFFu, in));\n", "")]
EXTRA = {"no-stage": _NO_STAGE, "stage-only": _NO_PRODUCT + _NO_KEY}
# Block shapes, name: (queries a block, blocks an SM). The blocks an SM are
# the kernel's __launch_bounds__ minimum, edited in the source; both are
# set in the wrapper when the variant is timed.
SHAPES = {"16": (16, 3), "32": (32, 2), "16x4": (16, 4)}
_MIN_BLOCKS = "constexpr int kMinBlocks = 3;"


def _shape_edits(shape: str):
    return [(_MIN_BLOCKS, f"constexpr int kMinBlocks = {SHAPES[shape][1]};")] if shape else []


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=10_000_037)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build and time (" + ", ".join(VARIANTS)
                         + "); `full` alone measures any tree, whatever its kernel")
    ap.add_argument("--extra", action="store_true",
                    help="also the cuts " + ", ".join(EXTRA))
    ap.add_argument("--shapes", default="",
                    help=f"comma-separated block shapes ({', '.join(SHAPES)}: queries a block, "
                         "x blocks an SM) to build every variant at; default: the source's own")
    ap.add_argument("--batches", default=str(SERVE_Q),
                    help="comma-separated numbers of queries a call (the first that many of "
                         "the request queries)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("topk_split: no CUDA device")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch import prng
    from repro_torch.core.binarize_lib import BinarizerConfig, init_binarizer, make_encode_fn
    from repro_torch.data.synthetic import clustered_corpus_torch
    from repro_torch.index.flat import FlatSDC
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdc import sdc
    from repro_torch.launch.serve import encode_codes

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"[split] tree {tree} on {smi}", flush=True)

    # -- variants of the kernel source, built together ---------------------
    shapes = [s for s in args.shapes.split(",") if s] or [""]
    cuts = {v: VARIANTS[v] for v in args.variants.split(",")}
    cuts.update(EXTRA if args.extra else {})
    variants = {f"{name}{f'@{s}' if s else ''}": _shape_edits(s) + edits
                for s in shapes for name, edits in cuts.items()}
    sources = build_variants(_build.build, Path(sdc._SOURCE), variants,
                             _build.BUILD_DIR / "topk_split", "topk_split")
    for name, src in sources.items():
        for kernel, line in register_lines(_build.library_path(src).with_suffix(".log"),
                                           r"sdc_scan_kernelILi128E"):
            packed = kernel.split("ILi128ELb")[1][0]
            print(f"[split] build {name}: sdc_scan_kernel D=128 packed={packed}: {line}")

    # -- the serving shapes of chip_smoke.py -------------------------------
    batches = [int(x) for x in args.batches.split(",")]
    docs, queries, _ = clustered_corpus_torch(args.seed, args.docs, max(N_QUERIES, *batches),
                                              DIM, device=device)
    bcfg = BinarizerConfig(input_dim=DIM, code_dim=CODE_DIM, n_levels=LEVELS, hidden_dim=2 * DIM)
    model = init_binarizer(bcfg, prng.key(args.seed, device), device)
    d_codes = encode_codes(model, docs, batch=1 << 17)
    del docs
    q = make_encode_fn(model)(queries)
    calls = {}
    for packed in (False, True):
        index = FlatSDC.build(d_codes, LEVELS, packed=packed, device=device)
        for b in batches:
            tag = ("packed" if packed else "int8") + (f"/Q{b}" if b != SERVE_Q else "")
            calls[tag] = ((q[:b], index.codes, index.inv_norm),
                          dict(n_levels=LEVELS, k=K, packed=packed))
    del d_codes
    torch.cuda.synchronize()

    occupancy = {}

    def use(name):
        sdc._SOURCE = sources[name]
        sdc._lib.cache_clear()
        shape = name.partition("@")[2]  # none: the source's own
        if shape:
            sdc._TOPK_QUERIES_PER_BLOCK, sdc._TOPK_BLOCKS_PER_SM = SHAPES[shape]
        if hasattr(sdc, "_queries_per_block"):  # an earlier design has none
            sdc._queries_per_block.cache_clear()
        lib = sdc._lib()
        ask = lib.sdc_topk_blocks_per_sm

        def record(D, packed, cap, qc):
            per_sm = ask(D, packed, cap, qc)
            occupancy[(name, packed)] = (qc, per_sm)
            return per_sm

        lib.sdc_topk_blocks_per_sm = record

    def call_ms(tag):
        a, kw = calls[tag]
        return time_ms(lambda: sdc.sdc_topk(*a, **kw), args.reps)

    names = list(variants)
    order = names + [names[0]]
    times = {}
    for i, name in enumerate(order):
        use(name)
        key = name if i < len(names) else f"{name} again"
        times[key] = {tag: call_ms(tag) for tag in calls}
        print(f"[split] {key:14s} " + "  ".join(f"{t} {ms:.3f} ms" for t, ms in times[key].items()),
              flush=True)
    for (name, packed), (qc, per_sm) in occupancy.items():
        print(f"[split] occupancy {name} packed={packed}: {qc} queries a block, "
              f"{per_sm} blocks an SM")
    if set(VARIANTS) <= set(cuts):
        for s in shapes:
            at = f"@{s}" if s else ""
            for tag in calls:
                t = {v: times[v + at][tag] for v in VARIANTS}
                print(f"[split] {tag}{at}: full {t['full']:.3f} ms; product "
                      f"{t['full'] - t['no-product']:.3f}, selector "
                      f"{t['full'] - t['no-selector']:.3f} (first round "
                      f"{t['warm-up'] - t['no-selector']:.3f}), keys "
                      f"{t['no-selector'] - t['no-key']:.3f}, no key {t['no-key']:.3f}, neither "
                      f"{t['neither']:.3f} ms on {smi}", flush=True)

    # -- the scan and merge kernels alone, where the profiler sees them ----
    for s in shapes:
        use(f"{names[0].partition('@')[0]}{f'@{s}' if s else ''}")
        for tag in calls:
            a, kw = calls[tag]
            rows = profiled_kernels(lambda: sdc.sdc_topk(*a, **kw), args.reps,
                                    r"sdc_\w+_kernel")
            print(f"[split] profiler {tag}{f'@{s}' if s else ''}: {rows}", flush=True)


if __name__ == "__main__":
    main()
