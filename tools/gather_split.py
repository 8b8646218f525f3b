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
  no-product   the code product cut out (the parent's per-pair dp4a loop
               becomes one XOR of a row word and a query word; the tile
               product is skipped and its dot tile left as it is)
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
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVE_Q, N_QUERIES, K = 64, 512, 10
DIM, CODE_DIM, LEVELS = 256, 128, 4
PROBE_BUDGET = 2080

# Each cut is a list of edits. An edit lists its alternatives, one per
# version of the kernel where they differ (the dp4a scan first, then the
# tile-product scan): exactly one must be found in the source.
_INSERT = [("for (int j = 0; j < np; ++j) sel.insert(j, key_of(j));",
            "for (int j = 0; j < np; ++j) { if (key_of(j) == 1ull) sel.count[j] = -1; }")]
_END_ROUND = [("sel.end_round(np, key_of);", "__syncthreads();")]
_NO_PRODUCT = [
    ("row_dot<PACKED>(a, b, qs + j * R::QSTRIDE)", "(int)(a[0] ^ (unsigned)qs[j * R::QSTRIDE])"),
    ("tile_dots<D, PACKED>(tile, qs, dots, np);",
     "for (int j = 0; j < np; ++j) dots[j * kDotStride + threadIdx.x] = "
     "(int)(tile[threadIdx.x * T::S] ^ (unsigned)qs[j * T::QS]);"),
]
# `warm` is true through a block's first live round (the tile-product
# version has it already).
_WARM_LOOP = [
    ("slice_rows);\n  for (int r = begin; r < end; r += kThreads) {",
     "slice_rows);\n  bool warm = true;\n  for (int r = begin; r < end; r += kThreads) {"),
    ("bool warm = true;\n", "bool warm = true;\n"),
]
_WARM_INSERT = [("for (int j = 0; j < np; ++j) sel.insert(j, key_of(j));",
                 "for (int j = 0; j < np; ++j) { if (warm) sel.insert(j, key_of(j)); "
                 "else if (key_of(j) == 1ull) sel.count[j] = -1; }")]
_WARM_END = [
    ("\n    sel.end_round(np, key_of);\n", "\n    { const bool any = __syncthreads_or(valid); "
     "if (warm && any) { sel.end_round(np, key_of); warm = false; } }\n"),
    ("\n      sel.end_round(np, key_of);\n",
     "\n      if (warm) sel.end_round(np, key_of); else __syncthreads();\n"),
]
VARIANTS = {
    "full": [],
    "no-product": [_NO_PRODUCT],
    "no-selector": [_INSERT, _END_ROUND],
    "warm-up": [_WARM_LOOP, _WARM_INSERT, _WARM_END],
    "neither": [_NO_PRODUCT, _INSERT, _END_ROUND],
}


def variant_source(text: str, edits) -> str:
    for alternatives in edits:
        hits = [(p, r) for p, r in alternatives if p in text]
        if len(hits) != 1:
            raise SystemExit(f"gather_split: {len(hits)} of {[p for p, _ in alternatives]} "
                             "found in the kernel source")
        text = text.replace(*hits[0])
    return text


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=10_000_037)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--pairs", default="",
                    help="comma-separated pairs per scan block to time the full kernel at, "
                         "besides the wrapper's own choice (the tile-product version only)")
    ap.add_argument("--waves", default="",
                    help="comma-separated grid depths (the wrapper's _WAVES) for that sweep")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gather_split: no CUDA device")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.binarize_lib import BinarizerConfig, init_binarizer, make_encode_fn
    from repro_torch.data.synthetic import clustered_corpus_torch
    from repro_torch.index import ivf
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdc import gather
    from repro_torch.launch.serve import IVF_KMEANS_ITERS, IVF_NLIST, IVF_NPROBE, IVF_SEED, \
        encode_codes

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[split] tree {tree} on {smi}", flush=True)

    # -- variants of the kernel source, built together ---------------------
    csrc = Path(gather._SOURCE).parent
    text = Path(gather._SOURCE).read_text()
    out = _build.BUILD_DIR / "gather_split"
    sources = {}
    for name, edits in VARIANTS.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "gather_topk.cu").write_text(variant_source(text, edits))
        sources[name] = d / "gather_topk.cu"
    libs = _build.build(list(sources.values()))
    for name, lib in zip(sources, libs):
        kernel = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"gather_scan_kernelILi128ELb([01])ELb([01])E", line)
            if m:
                kernel = f"gather_scan_kernel D=128 packed={m.group(1)} masked={m.group(2)}"
            elif ("registers" in line or "spill" in line) and kernel:
                print(f"[split] build {name}: {kernel}: "
                      f"{line.replace('ptxas info    :', '').strip()}")
                if "registers" in line:
                    kernel = None

    # -- the serving shapes of chip_smoke.py -------------------------------
    docs, queries, _ = clustered_corpus_torch(args.seed, args.docs, N_QUERIES, DIM, device=device)
    bcfg = BinarizerConfig(input_dim=DIM, code_dim=CODE_DIM, n_levels=LEVELS, hidden_dim=2 * DIM)
    model = init_binarizer(bcfg, torch.Generator(device=device).manual_seed(args.seed), device)
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

    def time_ms(tag):
        a, kw = calls[tag]
        fn = lambda: gather.sdc_gather_topk(*a, **kw)  # noqa: E731
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    order = list(VARIANTS) + ["full"]
    times = {}
    for i, name in enumerate(order):
        use(name)
        key = name if i < len(VARIANTS) else "full again"
        times[key] = {tag: time_ms(tag) for tag in calls}
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
    choose = getattr(gather, "_pairs_per_block", None)
    waves0 = gather._WAVES
    for waves in [int(x) for x in args.waves.split(",") if x] or [waves0]:
        gather._WAVES = waves
        for qc in [int(x) for x in args.pairs.split(",") if x]:
            gather._pairs_per_block = lambda D, packed, cap, qc=qc: qc
            t = {tag: time_ms(tag) for tag in calls}
            print(f"[split] full, {qc} pairs a block, {waves} waves: "
                  + "  ".join(f"{tag} {ms:.3f} ms" for tag, ms in t.items()), flush=True)
    gather._WAVES = waves0
    if choose is not None:
        gather._pairs_per_block = choose
        print(f"[split] the wrapper's choice at D={CODE_DIM}, k={K}: "
              f"{choose(CODE_DIM, False, gather.cap_for(K))} pairs a block int8, "
              f"{choose(CODE_DIM, True, gather.cap_for(K))} packed", flush=True)

    # -- the scan and merge kernels alone, where the profiler sees them ----
    from torch.profiler import ProfilerActivity, profile

    for tag in calls:
        a, kw = calls[tag]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                gather.sdc_gather_topk(*a, **kw)
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
            m = re.search(r"gather_\w+_kernel", ev.key or "")
            if dev_us and m:
                rows.append(f"{m.group(0)} {dev_us / 1e3 / args.reps:.3f} ms")
        print(f"[split] profiler {tag}: " + ("; ".join(rows) if rows else "no device time"),
              flush=True)


if __name__ == "__main__":
    main()
