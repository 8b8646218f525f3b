#!/usr/bin/env python3
"""Where the time of the ``sdc_topk`` flat scan goes, measured by kernel variants.

    python3 tools/topk_split.py [--tree .] [--seed 0] [--docs 0] [--rising] [--reps 10]
                                [--variants full,...] [--extra] [--shapes 16,16x4]
                                [--batches 64,256,1024] [--int8] [--table]

Run on a CUDA card from the root of a checkout; ``--tree`` names the
checkout whose ``src/repro_torch`` is measured (another commit unpacked
beside this one, for example). It makes the corpus of each benchmark cell
from the seed, as ``bench_port/`` does (a chunk of a million documents at
a time, encoded by the binarizer of the seed's weights), and keeps only
what its ``sdc_topk`` call scans, nibble-packed:

  web     bebr-web-flat: 100M documents, D 128 at 4 levels, k 10
  video   bebr-video-bigranular's coarse tier: 200M documents, D 64 at
          2 levels, k 160

``--docs`` cuts both corpora to that many documents (0: the cells' own).
``--rising`` also times each scan over its corpus sorted by the first
query's score, against that query repeated: every row is at least as good
as the ones before it, so nearly every pair passes the kernel's gate and
every round overflows the selector's buffers (the kernel's worst case).
``--int8`` also times each scan over its codes as int8 rows, one code a
byte (the fused kernel's other route). ``--table`` also times the kernel
table's other shapes (PERF.md section 6, rows 1a-1d) over the first
documents of the cells' corpora, int8 unless named packed:

  1c          web's codes, 64 queries over 2,500,009 documents (the
              engine's leaf)
  web/N20000, web/N10000
              64 queries over 20,000 and 10,000 (the upgrade and compat
              searches)
  video/k10   video's coarse corpus, packed, at k 10
  1d          video's coarse codes, 32 queries over 20,000, k 100 (the
              two-tower search's shape; its codes have 4 levels, these 2)
  1d/N1M      one query over 1,000,000, k 100 (tt_retrieval_bebr_step)

With ``--docs 10000000``, ``web`` and ``web/int8`` are rows 1b and 1a's
shapes and ``video`` the bi-granular coarse scan at 10M documents.
It takes the first 64 queries of the cell's pool, then compiles variants
of the tree's ``sdc_topk.cu`` in which one part is cut out by text
substitution and times each whole call with CUDA events:

  full         the kernel as it is
  no-product   the tile product skipped, its accumulators filled with one
               XOR of a row word and a query word
  no-key       the product, but no epilogue and no key: one compare per
               (query, document) pair of its accumulator, and no selector
  no-selector  every pair's epilogue and gate, which lets none through
               (its threshold stays -inf, and the compare is for
               equality): no key, and each round closes on one barrier
  warm-up      the gate and the selector run on each block's first round
               only
  neither      no product and no selector

The split follows: product = full - no-product, selector = full -
no-selector (the keys past the gate and their selection), first-round
selector work = warm-up - no-selector, keys = no-selector - no-key (the
epilogue and the gate of every pair). ``full`` is timed first and last to
show drift, and the kernel's counters (``sdc_topk.gate_counts``, where the
tree has them) give the share of pairs that passed the gate. Each
variant's registers come from its build log, and each call's geometry
(queries a block, slices, documents a slice) from the wrapper; a
profiler pass gives the scan and merge kernels' own times where the
profiler sees the card. ``--extra`` adds

  no-stage     no row staged (the norms still are): stale rows scored
  stage-only   the staging and barriers alone: no product, epilogue or
               selector

``--shapes`` builds every variant again at each block shape named, with
the kernel's ``kMinBlocks`` edited and the wrapper's shape set to match:
16 (queries a block, three blocks an SM, the kernel's own), 16x4 (four),
and 13, 11, 8 and 4 at three. A shape fixes the queries a block holds
(fewer only where its shared memory cannot hold them), where the wrapper
would pick them by its cost of staging and selection (``_scan_chunks``). ``--batches`` times every variant at other numbers of queries a
call. The cuts are text edits of this kernel's source; ``--variants full``
builds none, so it times any tree (an earlier design of the kernel) at
the same shapes.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

from split_common import build_variants, card, profiled_kernels, register_lines, time_ms

ROOT = Path(__file__).resolve().parents[1]
SERVE_Q = 64
# scan: (the benchmark's configuration, its key of the scan's levels, of its k)
SCANS = {"web": ("bebr-web-flat", "n_levels", "k"),
         "video": ("bebr-video-bigranular", "coarse_levels", "k_coarse")}

# Each cut is a list of edits (pattern, replacement); each pattern must be
# found in the source.
_PRODUCT = "round_products<D, PACKED>(words, qs, ng, c);"
_EPILOGUE = """              const float dot = exact_float(c[h][G][2 * hi + e]);
              const float v = __fadd_rn(__fmul_rn(c1, dot), __fmul_rn(c2, __fadd_rn(qf[G][e], sd)));
              const float s = __fmul_rn(__fadd_rn(v, c3), wi);"""
_GATE = "!(s < thr[G][e]);"
_CLOSE = "if (close_round(sel, nq, cut, lost, rescore)) read_thresholds();"
_NO_PRODUCT = [(_PRODUCT, "for (int h = 0; h < 2; ++h) for (int G = 0; G < kGroups; ++G) "
                          "for (int i = 0; i < 4; ++i) c[h][G][i] = (int)((tile[row0 * T::S + h] "
                          "^ (unsigned)qs[(8 * G + 2 * t + (i & 1)) * T::QS]) & 0xFFFF);")]
# The gate compares every score with the query's threshold, which stays
# -inf without a selector, and lets none through.
_NO_SELECTOR = [(_GATE, "s == thr[G][e];"), (_CLOSE, "__syncthreads();")]
_NO_KEY = [(_EPILOGUE, "              const float s = __int_as_float(c[h][G][2 * hi + e]);")] \
    + _NO_SELECTOR
# A block's first round is the one at r == begin.
_WARM_UP = [(_GATE, "(r == begin ? !(s < thr[G][e]) : s == thr[G][e]);"),
            (_CLOSE, "if (r == begin) { " + _CLOSE + " } else { __syncthreads(); }")]
VARIANTS = {
    "full": [],
    "no-product": _NO_PRODUCT,
    "no-key": _NO_KEY,
    "no-selector": _NO_SELECTOR,
    "warm-up": _WARM_UP,
    "neither": _NO_PRODUCT + _NO_SELECTOR,
}
# No row is staged (every round scores stale rows; the norms are still
# copied), or only the staging is left (no product, epilogue or selector).
_NO_STAGE = [("    stage_rows<D, PACKED>(tile, docs + r * R::ROW_BYTES, "
              "__ballot_sync(0xFFFFFFFFu, in));\n", "")]
EXTRA = {"no-stage": _NO_STAGE, "stage-only": _NO_PRODUCT + _NO_KEY}
# Block shapes, name: (queries a block, blocks an SM). The blocks an SM are
# the kernel's __launch_bounds__ minimum, edited in the source; both are
# set in the wrapper when the variant is timed.
SHAPES = {"16": (16, 3), "16x4": (16, 4), "13": (13, 3), "11": (11, 3), "8": (8, 3),
          "4": (4, 3)}
_MIN_BLOCKS = "constexpr int kMinBlocks = 3;"


def _shape_edits(shape: str):
    return [(_MIN_BLOCKS, f"constexpr int kMinBlocks = {SHAPES[shape][1]};")] if shape else []


# --table: tag, scan whose corpus it reads, queries, documents, k, int8 rows
TABLE = [("1c", "web", 64, 2_500_009, 10, True),
         ("web/N20000", "web", 64, 20_000, 10, True),
         ("web/N10000", "web", 64, 10_000, 10, True),
         ("video/k10", "video", 64, 0, 10, False),
         ("1d", "video", 32, 20_000, 100, True),
         ("1d/N1M", "video", 1, 1_000_000, 100, True)]


def int8_rows(codes):
    """Nibble-packed codes [N, D/2] as int8 rows [N, D], a million at a time."""
    import torch

    from repro_torch.core.binarize_lib import unpack_codes_nibbles

    out = torch.empty((codes.shape[0], 2 * codes.shape[1]), dtype=torch.int8,
                      device=codes.device)
    for s in range(0, codes.shape[0], 1 << 20):
        out[s:s + (1 << 20)] = unpack_codes_nibbles(codes[s:s + (1 << 20)])
    return out


def scan_operands(scan: str, seed: int, docs: int, n_queries: int, device):
    """((queries, codes, inverse norms), sdc_topk's keywords) of a cell's scan:
    its corpus made and encoded a chunk at a time as ``bench_port/cell.py``
    does, each chunk indexed by the tree's ``FlatSDC.build`` at the scan's
    levels, and the first ``n_queries`` of its query pool."""
    import torch

    from bench_port import spec
    from bench_port import weights as weights_lib
    from bench_port.corpus import Corpus
    from repro_torch.core.binarize_lib import (BinarizerConfig, binarizer_from_numpy,
                                               coarse_codes, make_encode_fn)
    from repro_torch.index.flat import FlatSDC

    name, levels_key, k_key = SCANS[scan]
    cfg = spec.config(spec.benchmark(), name)
    cfg["n_docs"] = docs or cfg["n_docs"]
    L, C, D = cfg["n_levels"], cfg[levels_key], cfg["code_dim"]
    params, state = weights_lib.make(cfg, seed, device)
    model = binarizer_from_numpy(params, state, BinarizerConfig(
        input_dim=cfg["input_dim"], code_dim=D, n_levels=L, hidden_dim=cfg["hidden_dim"]),
        device=device)
    encode = make_encode_fn(model)
    corpus = Corpus(cfg, seed, device)
    codes = torch.empty((cfg["n_docs"], D // 2), dtype=torch.uint8, device=device)
    inv = torch.empty((cfg["n_docs"],), dtype=torch.float32, device=device)
    for c in range(corpus.n_chunks):
        s, e = corpus.bounds(c)
        raw = corpus.raw(c)
        corpus.collect(c, raw)
        part = FlatSDC.build(coarse_codes(encode(corpus.docs(c, raw)), L, C), C, packed=True,
                             device=device)
        codes[s:e], inv[s:e] = part.codes, part.inv_norm
    pool = torch.as_tensor(corpus.queries()[:n_queries], device=device)
    q = coarse_codes(encode(pool), L, C)
    return (q, codes, inv), dict(n_levels=C, k=cfg[k_key], packed=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=0,
                    help="documents of each corpus (0: the cell's own)")
    ap.add_argument("--rising", action="store_true",
                    help="also each scan over its corpus sorted by the first query's score")
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
    ap.add_argument("--int8", action="store_true",
                    help="also each scan over its codes as int8 rows")
    ap.add_argument("--table", action="store_true",
                    help="also the kernel table's other shapes: " + ", ".join(t[0] for t in TABLE))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("topk_split: no CUDA device")
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdc import sdc

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
                                           r"sdc_scan_kernelILi(64|128)ELb1E"):
            D = re.search(r"ILi(\d+)E", kernel).group(1)
            print(f"[split] build {name}: sdc_scan_kernel D={D} packed: {line}")

    # -- the cells' scans ---------------------------------------------------
    batches = [int(x) for x in args.batches.split(",")]
    calls = {}
    for scan in SCANS:
        operands, kw = scan_operands(scan, args.seed, args.docs, max(batches), device)
        q, codes, inv = operands
        print(f"[split] {scan}: {codes.shape[0]} documents, D {q.shape[1]}, {kw}", flush=True)
        for b in batches:
            calls[scan + (f"/Q{b}" if b != SERVE_Q else "")] = ((q[:b], codes, inv), kw)
        rows = int8_rows(codes) if args.int8 or args.table else None
        if args.int8:
            calls[scan + "/int8"] = ((q[:SERVE_Q], rows, inv), dict(kw, packed=False))
        for tag, of, nq, n, k, int8 in TABLE if args.table else ():
            if of == scan:
                n = n or codes.shape[0]
                calls[tag] = ((q[:nq], (rows if int8 else codes)[:n], inv[:n]),
                              dict(kw, k=k, packed=not int8))
        if args.rising:
            s = sdc.sdc_scores(q[:1], codes, inv, n_levels=kw["n_levels"], packed=True)[0]
            order = torch.sort(s, stable=True).indices
            del s
            calls[scan + "/rising"] = ((q[:1].expand(SERVE_Q, -1).contiguous(),
                                        codes[order], inv[order]), kw)
            del order
    torch.cuda.synchronize()

    geometry = {}
    pick = getattr(sdc, "_scan_chunks", None)  # an earlier design has none

    def fixed(Q, N, W, packed, k, device):
        qc = min(Q, sdc._queries_per_block(W, packed, sdc.cap_for(k)))
        return qc, sdc._scan_blocks_per_sm(W, packed, k, qc, device)

    def use(name):
        sdc._SOURCE = sources[name]
        sdc._lib.cache_clear()
        shape = name.partition("@")[2]  # none: the source's own
        if shape:
            sdc._TOPK_QUERIES_PER_BLOCK, sdc._TOPK_BLOCKS_PER_SM = SHAPES[shape]
        for cached in (getattr(sdc, "_queries_per_block", None), pick):  # or neither
            if cached is not None:
                cached.cache_clear()
        if pick is not None:
            sdc._scan_chunks = fixed if shape else pick

    def call_ms(name, tag):
        a, kw = calls[tag]
        ms = time_ms(lambda: sdc.sdc_topk(*a, **kw), args.reps)
        geometry[(name, tag)] = sdc.sdc_topk.last_geometry
        return ms

    names = list(variants)
    order = names + [names[0]]
    times = {}
    for i, name in enumerate(order):
        use(name)
        key = name if i < len(names) else f"{name} again"
        times[key] = {tag: call_ms(name, tag) for tag in calls}
        print(f"[split] {key:14s} " + "  ".join(f"{t} {ms:.3f} ms" for t, ms in times[key].items()),
              flush=True)
    if hasattr(sdc.sdc_topk, "gate_counts"):  # an earlier design has none
        use(names[0])
        for tag in calls:
            a, kw = calls[tag]
            before = sdc.sdc_topk.gate_counts(device)
            sdc.sdc_topk(*a, **kw)
            pairs, passed = (x - y for x, y in zip(sdc.sdc_topk.gate_counts(device), before))
            print(f"[split] gate {tag} ({names[0]}): {passed} of {pairs} pairs passed "
                  f"({100 * passed / max(pairs, 1):.4f}%)", flush=True)
    for name in names:
        print(f"[split] geometry {name} (queries a block, slices, documents a slice): "
              + "  ".join(f"{tag} {geometry[(name, tag)]}" for tag in calls))
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
