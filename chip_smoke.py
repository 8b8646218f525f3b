#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--docs 10000037]

Run from the root of a checkout. It builds the CUDA kernels from the
sources in the checkout, then, in order, and failing on the first phase
that fails:

  1. prints the card, the device count and the card's power limit;
  2. holds every kernel against its plain PyTorch version on the card
     (exactly equal scores and ids) in the edge cases: n_levels 1, 2, 4
     in int8 and nibble-packed form, k > N, k = 1, 1024 and K_MAX, an
     all-excluded tail, duplicated documents (ties), Q not a multiple of
     any tile and cut at every query-chunk edge, N a multiple of neither
     128 nor 256, code dims 16 and 48 (padded) beside 32 and 256, and
     264, 300 and 512 (the unfused route, with excluded documents); a flat
     request at code dim 16 and a search for k = 5000 (sdc_scores and a
     stable sort) through FlatSDC;
  3. drives the flat serving path at the serving defaults (dim 256,
     code_dim 128, n_levels 4, hidden 512, k 10) over a clustered corpus
     of ten million documents made on the card: encode, build FlatSDC
     int8 and packed, serve 8 requests of 64 queries through
     ServingPipeline and check them against serve_sequential, against
     each other, against the plain version, and that every search went
     through the kernel (launch counts are zeroed just before and read
     just after each run);
  4. times the kernel, its plain version, the HBM bound and a library
     yardstick at the main path's shapes, and the serving drivers;
  5. holds the gather kernel (int8, packed, masked) and the unfused
     sdc_scores kernel against their plain versions, exactly, in their
     edge cases: padded lists, probes out of range, k > nprobe * L, masks
     leaving fewer than k or no live slots, equal scores across lists,
     lists of 17 and of 150,001 rows, k = 1024, Q a multiple of no tile,
     nprobe = nlist against sdc_topk over the same documents, and the
     gather's unfused route (k = 4097 and 5000, code dims 264, 300 and
     512) with the route checked by the launch counts; sdc_scores at code
     dims up to 512; dot_interact at ragged B, F of 2, 5 and 40, and D of
     13, 65, 300 and 1100;
  6. drives the IVF serving path over phase 3's codes: build_ivf on the
     card (nlist 64, 20 k-means iterations, seed 1), twice, checked
     identical, int8 and packed; 8 requests of 64 queries at nprobe 32
     and under the probe budget 2,080 (the masked kernel), each checked
     against serve_sequential, the plain version and the other form, with
     launch counts zeroed just before and read just after every run; the
     budget 32 * 64 against nprobe 32; the unfused flat search
     (ops.sdc_search(fused=False)) of one request against the fused one;
     the unfused routes at the CLI's batch, 1,024 queries at k = 5000 over
     the flat index and the IVF lists (chunked by free memory), four of
     them against the plain versions;
  7. times the new kernels, their plain versions, bounds and yardsticks at
     the main path's shapes, the IVF build and the IVF serving drivers,
     and holds the whole sdc_scores matrix at those shapes (int8 and
     packed) against its plain version, exactly;
  8. drives the bitwise baseline over phase 3's codes: FlatBitwise (the
     codes' bit planes, xor + popcount in the binary_dot kernel) serves
     the 8 requests of 64 queries, checked against serve_sequential and
     the plain search, with launch counts zeroed just before and read
     just after; holds the whole [64, N] binary_dot matrix against its
     plain version, exactly; times the kernel at n_levels 1, 2 and 4
     (planes of coarse_codes) beside sdc_scores, its plain version and
     its popcount bound;
 8b. drives bi-granular retrieval over phase 3's codes (a coarse scan
     over the first C levels, each query's top-k' survivors reranked on
     the full-level codes by the gather kernel): flat with the fine tier
     on the card at (C, k') = (2, 40), (2, 160) and (3, 160), coarse tier
     packed, 8 requests of 64 queries each through ServingPipeline,
     checked against serve_sequential and the plain version, the
     sdc_topk and sdc_gather_topk launch counts zeroed just before and
     read just after every run; the fine tier in host memory at (2, 160),
     bit-identical to the card's; k' = 5000 (the coarse scan's unfused
     route, sdc_scores), 4 queries against the plain version; IVF at
     (2, 160) (nlist 64, nprobe 32, seed 1); times the coarse scan beside
     the full-level one, the rerank with its fine tier on the card and in
     host memory (the grouping of pairs, the scan and merge kernels, the
     host gather and the upload apart), its plain versions and byte
     bounds, and the serving drivers;
 8c. drives the HNSW graph search at the CLI's width over a clustered
     corpus of 20,000 documents (the CLI's default): the NSW graph built
     on the host (M 16, ef_construction 64), int8 and packed (the same
     graph), its neighbour-block tables on the card; 8 requests of 64
     queries at ef 64, beam 8, max_hops 64 through ServingPipeline, each
     held against serve_sequential, the plain version on the same tables
     and the other form, with the sdc_topk (entry scoring) and
     sdc_gather_topk (one a hop) launch counts and the walk's host reads
     zeroed just before and read just after every run; bi-granular at
     (C, k') = (2, 160), the fine tier in host memory; one request at the
     full hop budget against its early exit; walks from doc 0 alone and
     from a node next to it beside invalid entries (repeated indices)
     against the plain version on the CPU; times the build, one hop split
     into its steps (entry scoring, beam selection, dedupe, plan, gather,
     merge), the gather beside its plain version and byte bound, and the
     serving drivers;
  9. drives the dlrm-rm2 serving forward at full width (26 tables of
     1,048,576 x 64 float32, 6.98 GB, seeded): dlrm_serve_step on 3
     batches each at B = 512 and B = 262,144, with the dot_interact
     launch count zeroed just before and read just after; holds the
     kernel against its plain version on every batch, exactly, and the
     logits against forwards with the plain interaction (exactly) and with
     the Gram-matrix formulation (within float32 rounding); times the
     kernel (and its device time by torch.profiler), its plain version,
     its bound and the torch.bmm yardstick.

Its last two lines are a JSON object of the kernels' numbers and
``{"ok": true, "device": {...}}``. The binarizer's weights are seeded and
untrained, so the recall it prints is information only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores, NVIDIA data sheet
# __popc results per SM per clock, compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions); times
# the SM count and the maximum SM clock that nvidia-smi reports.
POPC_PER_SM_CLOCK = 16
SERVE_Q, SERVE_REQUESTS, K = 64, 8, 10
DIM, CODE_DIM, LEVELS = 256, 128, 4
SOURCE = "src/repro_torch/kernels/sdc/csrc/sdc_topk.cu"
GATHER_SOURCE = "src/repro_torch/kernels/sdc/csrc/gather_topk.cu"
SCORES_SOURCE = "src/repro_torch/kernels/sdc/csrc/sdc_scores.cu"
BINARY_DOT_SOURCE = "src/repro_torch/kernels/binary_dot/csrc/binary_dot.cu"
DOT_INTERACT_SOURCE = "src/repro_torch/kernels/dot_interact/csrc/dot_interact.cu"
BINARY_DOT_REPLACES = "src/repro/kernels/binary_dot/kernel.py:61"
DOT_INTERACT_REPLACES = "src/repro/kernels/dot_interact/kernel.py:50"
DLRM_SHAPES = (("serve_p99", 512), ("serve_bulk", 262_144))  # repro/configs/cells.py RS_SHAPES
DLRM_BATCHES = 3
DEVICE = "cuda:0"
REPLACES = {False: "src/repro/kernels/sdc/sdc.py:318", True: "src/repro/kernels/sdc/sdc.py:303"}
GATHER_REPLACES = "src/repro/kernels/sdc/gather.py:176"
SCORES_REPLACES = {False: "src/repro/kernels/sdc/sdc.py:195", True: "src/repro/kernels/sdc/sdc.py:183"}
PROBE_BUDGET = 2080  # not a multiple of nlist = 64: runs the masked kernel
# bi-granular (coarse levels C, survivors k'): served from the device tier;
# the first of RERANK_TIMED's shape also from the host tier, through IVF,
# and timed; k' = 5000 (past K_MAX) takes the coarse scan's unfused route
RERANK_CONFIGS = ((2, 40), (2, 160), (3, 160))
RERANK_C, RERANK_KC = 2, 160
RERANK_WIDE_KC, RERANK_WIDE_ROWS = 5000, 4
# HNSW at the reference CLI's width: its default --docs (and the ceiling of
# its host build), --ef and --beam; the bi-granular walk at (C, k'); the
# hop whose state the split times
HNSW_DOCS, HNSW_EF, HNSW_BEAM = 20_000, 64, 8
HNSW_RERANK = (2, 160)
HNSW_SPLIT_HOP = 3


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, *kernels: str):
    """The device time per call of the kernels whose name holds each of
    ``kernels``, by torch.profiler (so without the host's launch
    overhead), or "not measured" where the profiler sees no device time;
    one string, or a list of them for several names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for kernel in kernels:
        us = sum(getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
                 for ev in prof.key_averages() if kernel in (ev.key or ""))
        out.append(f"{us / 1e3 / reps:.4f} ms" if us else "not measured")
    return out[0] if len(out) == 1 else out


def device_busy_ms(fn, reps: int):
    """The device time per call of every kernel ``fn`` launches, by
    torch.profiler, or "not measured" where the profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
             for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps if us else "not measured"


def host_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` on the host clock, each call ending in a device sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def edge_cases(device, gen) -> int:
    """Kernel vs plain version, exactly, in the edge cases. Returns the case count."""
    import torch

    from repro_torch.core.binarize_lib import pack_codes_nibbles
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ref import doc_inv_norms

    def case(Q, N, D, nl, k, packed, dup=False, tail=0, holes=""):
        q = torch.randint(0, 2**nl, (Q, D), generator=gen, device=device).to(torch.int8)
        d = torch.randint(0, 2**nl, (N, D), generator=gen, device=device).to(torch.int8)
        if dup:
            d[N // 2:] = d[: N - N // 2].clone()
        inv = doc_inv_norms(d, nl)
        if tail:
            inv[-tail:] = 0
        # exclusions inside the first round's parts of cap = cap_for(k) rows
        # (k < 128): every other row, or a quarter of one part's rows left
        # before a part whose buffer overflows
        n = torch.arange(N, device=device)
        part = min(sdc_mod.cap_for(k), 256)
        if holes == "alternate":
            inv[n % 2 == 0] = 0
        elif holes == "runs":
            inv[n % (2 * part) < part - part // 4] = 0
        dd = pack_codes_nibbles(d) if packed else d
        fused = k <= sdc_mod.K_MAX and D <= 256  # else: sdc_scores and a stable sort
        before = (sdc_mod.sdc_topk.launches, sdc_mod.sdc_scores.launches)
        v, i = sdc_mod.sdc_topk(q, dd, inv, n_levels=nl, k=k, packed=packed)
        pv, pi = sdc_mod.sdc_topk_torch(q, dd, inv, n_levels=nl, k=k, packed=packed)
        what = (f"Q={Q} N={N} D={D} n_levels={nl} k={k} packed={packed} dup={dup} tail={tail} "
                f"holes={holes or '-'}")
        check(torch.equal(v, pv) and torch.equal(i, pi), f"kernel != plain: {what}")
        check((sdc_mod.sdc_topk.launches, sdc_mod.sdc_scores.launches)
              == (before[0] + fused, before[1] + (not fused)), f"wrong kernel launched: {what}")
        if k > N or tail == N:
            check(bool((i[:, N - tail:] == -1).all()), f"empty slots not -1: {what}")
        log(f"[edge] ok {what}")

    cases = [(37, 100_003, 128, nl, K, p) for nl in (1, 2, 4) for p in (False, True)]
    cases += [
        (5, 50, 64, 4, 100, False),  # k > N
        (5, 50, 32, 4, 100, True),
        (64, 300_007, 128, 4, 1024, False),  # k = 1024, several query chunks
        (64, 300_007, 128, 4, 1024, True),
        (3, 1000, 128, 4, sdc_mod.K_MAX, False),  # the largest k
        (130, 70_001, 64, 2, 33, True),  # Q not a multiple of any tile
    ]
    # the tile-product scan's edges: query chunks cut at 1, 15, 16, 17, 64 and
    # 65 queries, N a multiple of neither 128 nor 256, code dims the wrapper
    # pads with zeros (16, 48), 32 and 256, k = 1 and K_MAX, and k = 5000
    # (past K_MAX: the sdc_scores kernel and a stable sort)
    cases += [(Q, 50_003, 128, 4, K, p) for Q in (1, 15, 16, 17, 64, 65) for p in (False, True)]
    cases += [
        (7, 20_011, 16, 4, K, False), (7, 20_011, 16, 4, K, True), (9, 20_011, 48, 2, 33, True),
        (33, 20_011, 32, 4, K, True), (33, 20_011, 256, 4, K, False),
        (5, 3_001, 128, 4, 1, False), (3, 9_001, 128, 4, sdc_mod.K_MAX, True),
        (3, 9_001, 16, 4, 5000, False), (3, 9_001, 128, 4, 5000, True),
    ]
    for c in cases:
        case(*c)
    case(64, 200_003, 128, 4, K, False, tail=5000)  # all-excluded tail
    case(7, 300, 128, 4, K, True, tail=300)  # everything excluded
    case(64, 200_003, 256, 4, K, True, dup=True)  # ties
    case(64, 200_003, 128, 1, K, False, dup=True)
    case(16, 100_003, 128, 1, 100, True, dup=True)
    holes = [(k, h, p) for k in (10, 33) for h in ("alternate", "runs") for p in (False, True)]
    for k, h, p in holes:
        case(64, 200_003, 128, 4, k, p, holes=h)
    # code dims above the fused kernel's widest (the unfused route: sdc_scores
    # and a stable sort), with excluded documents
    wide = [(17, 20_011, D, 4, K, p) for D in (264, 300, 512) for p in (False, True)]
    for c in wide:
        case(*c, tail=777)
    case(9, 20_011, 300, 2, 33, False, holes="alternate")
    case(3, 9_001, 512, 4, 5000, True, tail=100)
    return len(cases) + 5 + len(holes) + len(wide) + 2


def padded_requests(device, gen) -> None:
    """A flat request at code dim 16 (padded to 32 on the card) and a search
    for k = 5000 (past K_MAX), through FlatSDC, each equal to the plain version."""
    import torch

    from repro_torch.index.flat import FlatSDC
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ops import sdc_search_torch

    codes = torch.randint(0, 2**LEVELS, (1_000_003, 16), generator=gen, device=device)
    q = torch.randint(0, 2**LEVELS, (SERVE_Q, 16), generator=gen, device=device).to(torch.int8)
    for packed in (False, True):
        index = FlatSDC.build(codes, LEVELS, packed=packed, device=device)
        for k, counter in ((K, sdc_mod.sdc_topk), (5000, sdc_mod.sdc_scores)):
            counter.launches = 0
            v, i = index.search(q, k)
            check(counter.launches == 1, f"D=16 k={k}: {counter.__name__} launched "
                                         f"{counter.launches} times")
            pv, pi = sdc_search_torch(q, index.codes, index.inv_norm, n_levels=LEVELS, k=k,
                                      packed=packed)
            check(torch.equal(v, pv) and torch.equal(i, pi),
                  f"FlatSDC D=16 k={k} packed={packed}: card != plain")
            log(f"[edge] ok FlatSDC request Q={SERVE_Q} N={codes.shape[0]} D=16 k={k} "
                f"packed={packed} through {counter.__name__}")


def gather_edge_cases(device, gen) -> int:
    """Gather kernel vs plain version, exactly, in its edge cases. Returns the case count."""
    import torch

    from repro_torch.core.binarize_lib import pack_codes_nibbles
    from repro_torch.kernels.sdc import gather as gather_mod
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ref import doc_inv_norms

    def case(Q, nlist, L, D, nl, k, nprobe, packed, mask=None, ties=False, full=False,
             holes=False):
        codes = torch.randint(0, 2**nl, (nlist, L, D), generator=gen, device=device)
        codes = codes.to(torch.int8)
        if ties:  # every list a copy of list 0; later lists hold lower ids
            codes[1:] = codes[0].clone()
            ids = ((nlist - 1 - torch.arange(nlist, device=device))[:, None] * L
                   + torch.arange(L, device=device)).to(torch.int32)
        else:
            ids = torch.randperm(nlist * L, generator=gen, device=device).to(torch.int32)
            ids = ids.reshape(nlist, L)
        inv = doc_inv_norms(codes.reshape(-1, D), nl).reshape(nlist, L)
        pad = min(3, L - 1)
        inv[:, L - pad:] = 0
        ids[:, L - pad:] = -1
        if holes:  # -1 ids inside the lists (inv kept), and a run of dead rounds
            ids[torch.rand((nlist, L), generator=gen, device=device) < 0.1] = -1
            ids[:, L // 8:L // 8 + 600] = -1
        q = torch.randint(0, 2**nl, (Q, D), generator=gen, device=device).to(torch.int8)
        if full or ties:
            probes = torch.stack([torch.randperm(nlist, generator=gen, device=device)[:nprobe]
                                  for _ in range(Q)])
        else:  # out of range on both sides: clamped
            probes = torch.randint(-3, nlist + 3, (Q, nprobe), generator=gen, device=device)
        probes = probes.to(torch.int32)
        cand = None
        if mask in ("few", "half"):
            keep = 0.995 if mask == "few" else 0.5
            cand = (torch.rand((Q, nprobe, L), generator=gen, device=device) > keep).float()
        elif mask == "none":
            cand = torch.zeros((Q, nprobe, L), device=device)
        lc = pack_codes_nibbles(codes) if packed else codes
        fused = k <= sdc_mod.K_MAX and D <= 256  # else: sdc_scores and the selection
        before = (gather_mod.sdc_gather_topk.launches, sdc_mod.sdc_scores.launches)
        v, i = gather_mod.sdc_gather_topk(q, lc, inv, ids, probes, n_levels=nl, k=k,
                                          packed=packed, cand_mask=cand)
        route = (gather_mod.sdc_gather_topk.launches - before[0],
                 sdc_mod.sdc_scores.launches - before[1])
        pv, pi = gather_mod.sdc_gather_topk_torch(q, lc, inv, ids, probes, n_levels=nl, k=k,
                                                  packed=packed, cand_mask=cand)
        what = (f"Q={Q} nlist={nlist} L={L} D={D} n_levels={nl} k={k} nprobe={nprobe} "
                f"packed={packed} mask={mask} ties={ties} holes={holes}")
        check(torch.equal(v, pv) and torch.equal(i, pi), f"gather kernel != plain: {what}")
        check(route == ((1, 0) if fused else (0, 1)), f"gather: wrong kernel launched: {what}")
        live = v > -5e29
        check(bool((i[~live] == -1).all()), f"gather: empty slots not -1: {what}")
        if k > nprobe * L:
            check(bool((i[:, nprobe * L:] == -1).all()), f"gather: tail not -1: {what}")
        if mask == "few":
            check(bool((live.sum(1) < k).any()), f"gather: the mask left k live slots: {what}")
        if mask == "none":
            check(not bool(live.any()), f"gather: a masked slot came back: {what}")
        if full:  # nprobe = nlist: the same scores as a flat scan of every document
            keep = (inv > 0) & (ids >= 0)
            flat_codes = (pack_codes_nibbles(codes[keep]) if packed else codes[keep])
            fv, _ = sdc_mod.sdc_topk(q, flat_codes.contiguous(), inv[keep].contiguous(),
                                     n_levels=nl, k=k, packed=packed)
            check(torch.equal(v, fv), f"gather at nprobe = nlist != sdc_topk scores: {what}")
        log(f"[gather-edge] ok {what}")

    n = 0
    for nl in (1, 2, 4):
        for packed in (False, True):
            case(37, 16, 3001, 128, nl, K, 8, packed)  # padding, probes out of range
            n += 1
    cases = [
        dict(Q=5, nlist=8, L=17, D=64, nl=4, k=200, nprobe=4, packed=False),  # k > nprobe * L
        dict(Q=5, nlist=8, L=17, D=64, nl=4, k=200, nprobe=4, packed=True),
        dict(Q=9, nlist=8, L=500, D=128, nl=4, k=50, nprobe=4, packed=False, mask="few"),
        dict(Q=9, nlist=8, L=500, D=128, nl=2, k=50, nprobe=4, packed=True, mask="few"),
        dict(Q=4, nlist=8, L=300, D=64, nl=4, k=10, nprobe=3, packed=False, mask="none"),
        dict(Q=16, nlist=8, L=2000, D=128, nl=1, k=64, nprobe=8, packed=False, ties=True),
        dict(Q=16, nlist=8, L=2000, D=256, nl=4, k=64, nprobe=8, packed=True, ties=True),
        dict(Q=64, nlist=8, L=150_001, D=128, nl=4, k=K, nprobe=4, packed=False),  # large lists
        dict(Q=64, nlist=8, L=150_001, D=128, nl=4, k=K, nprobe=4, packed=True, mask="half"),
        dict(Q=130, nlist=64, L=17, D=32, nl=4, k=K, nprobe=16, packed=False),  # small lists
        dict(Q=64, nlist=16, L=20_000, D=128, nl=4, k=1024, nprobe=8, packed=False),  # k = 1024
        dict(Q=64, nlist=16, L=20_000, D=128, nl=4, k=1024, nprobe=8, packed=True),
        dict(Q=33, nlist=12, L=5000, D=128, nl=4, k=100, nprobe=12, packed=False, full=True),
        dict(Q=33, nlist=12, L=5000, D=128, nl=2, k=100, nprobe=12, packed=True, full=True),
        # the tile product's edges: 1, 7, 9 and 65 pairs on every list (65: several
        # units on one list), lengths no multiple of 16 or of the 256-row tile,
        # -1 ids inside the lists, D = 256, and k = K_MAX (one pair per block)
        dict(Q=1, nlist=6, L=999, D=128, nl=4, k=K, nprobe=6, packed=False, full=True),
        dict(Q=7, nlist=6, L=999, D=128, nl=4, k=K, nprobe=6, packed=True, full=True,
             holes=True),
        dict(Q=9, nlist=6, L=2049, D=64, nl=2, k=33, nprobe=6, packed=False, full=True,
             holes=True),
        dict(Q=65, nlist=6, L=3001, D=128, nl=4, k=K, nprobe=6, packed=False, full=True,
             holes=True),
        dict(Q=65, nlist=6, L=3001, D=128, nl=4, k=K, nprobe=6, packed=True, mask="half",
             holes=True),
        dict(Q=33, nlist=8, L=5003, D=256, nl=4, k=K, nprobe=4, packed=False, holes=True),
        dict(Q=33, nlist=8, L=5003, D=256, nl=4, k=K, nprobe=4, packed=True, mask="half"),
        dict(Q=5, nlist=4, L=3000, D=128, nl=4, k=sdc_mod.K_MAX, nprobe=2, packed=False,
             holes=True),
        dict(Q=5, nlist=4, L=3000, D=256, nl=4, k=sdc_mod.K_MAX, nprobe=2, packed=True,
             mask="half"),
        # the unfused route: k past K_MAX, with and without a mask, ids of -1
        # inside the lists, ties across lists; code dims above 256
        dict(Q=5, nlist=6, L=2000, D=128, nl=4, k=sdc_mod.K_MAX + 1, nprobe=4, packed=False,
             holes=True),
        dict(Q=5, nlist=6, L=2000, D=128, nl=4, k=sdc_mod.K_MAX + 1, nprobe=4, packed=True,
             mask="half", holes=True),
        dict(Q=7, nlist=6, L=2000, D=64, nl=2, k=5000, nprobe=4, packed=False, ties=True),
        dict(Q=7, nlist=6, L=2000, D=64, nl=1, k=5000, nprobe=4, packed=True, mask="few",
             holes=True),
        dict(Q=9, nlist=6, L=999, D=264, nl=4, k=K, nprobe=6, packed=False, full=True,
             holes=True),
        dict(Q=9, nlist=6, L=999, D=264, nl=4, k=K, nprobe=6, packed=True, mask="half"),
        dict(Q=33, nlist=8, L=2001, D=300, nl=2, k=33, nprobe=4, packed=False, holes=True),
        dict(Q=33, nlist=8, L=2001, D=300, nl=2, k=33, nprobe=4, packed=True, ties=True),
        dict(Q=5, nlist=4, L=1500, D=512, nl=4, k=K, nprobe=2, packed=False, mask="half"),
        dict(Q=5, nlist=4, L=1500, D=512, nl=4, k=5000, nprobe=4, packed=True, holes=True),
    ]
    for c in cases:
        case(**c)
    return n + len(cases)


def scores_edge_cases(device, gen) -> int:
    """sdc_scores kernel vs plain version, exactly. Returns the case count."""
    import torch

    from repro_torch.core.binarize_lib import pack_codes_nibbles
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ref import doc_inv_norms

    cases = [(37, 100_003, 128, nl, p) for nl in (1, 2, 4) for p in (False, True)]
    cases += [(130, 5_001, 64, 2, True), (3, 7, 32, 1, False), (64, 1, 256, 4, True),
              (65, 30_011, 256, 4, False)]
    # code dims above 256 (looped over in chunks of the kernel's staging)
    cases += [(Q, N, D, nl, p) for Q, N, D, nl in ((17, 20_011, 264, 2), (65, 10_007, 300, 4),
                                                    (5, 4_099, 512, 1)) for p in (False, True)]
    for Q, N, D, nl, packed in cases:
        q = torch.randint(0, 2**nl, (Q, D), generator=gen, device=device).to(torch.int8)
        d = torch.randint(0, 2**nl, (N, D), generator=gen, device=device).to(torch.int8)
        inv = doc_inv_norms(d, nl)
        inv[::7] = 0  # excluded documents
        dd = pack_codes_nibbles(d) if packed else d
        before = sdc_mod.sdc_scores.launches
        s = sdc_mod.sdc_scores(q, dd, inv, n_levels=nl, packed=packed)
        ps = sdc_mod.sdc_scores_torch(q, dd, inv, n_levels=nl, packed=packed)
        what = f"Q={Q} N={N} D={D} n_levels={nl} packed={packed}"
        check(sdc_mod.sdc_scores.launches == before + 1, f"sdc_scores did not launch: {what}")
        check(torch.equal(s, ps), f"sdc_scores kernel != plain: {what}")
        check(bool((s[:, ::7] == -1e30).all()), f"sdc_scores: excluded docs not -1e30: {what}")
        log(f"[scores-edge] ok {what}")
    return len(cases)


def dot_interact_edge_cases(device, gen) -> int:
    """dot_interact kernel vs plain version, exactly, at the edges of its
    stages and tiles. Returns the case count."""
    import torch

    from repro_torch.kernels.dot_interact import kernel as di_mod
    from repro_torch.kernels.dot_interact.ref import dot_interact_torch

    # (B, F, D): B ragged against the 8-example stages and one example; F of
    # 2, 5 and 40 (row blocks cut at the diagonal); D not a multiple of 4
    # (13, 65: 4-byte copies, zero padding); D large enough that a stage
    # holds 4, 2 or 1 examples (300, 600, 1100; B large enough that a wave of
    # blocks still takes whole stages)
    shapes = [(9, 2, 13), (17, 5, 65), (33, 40, 13), (1, 27, 64), (4099, 27, 64),
              (1001, 27, 65), (130, 40, 64), (4097, 5, 13), (600, 27, 300), (300, 27, 600),
              (2, 27, 1100)]
    for B, F, D in shapes:
        e = torch.randn((B, F, D), generator=gen, device=device)
        before = di_mod.dot_interact.launches
        got = di_mod.dot_interact(e)
        what = f"B={B} F={F} D={D}"
        check(di_mod.dot_interact.launches == before + 1, f"dot_interact did not launch: {what}")
        check(torch.equal(got, dot_interact_torch(e)), f"dot_interact kernel != plain: {what}")
        log(f"[dlrm-edge] ok dot_interact {what}")
    return len(shapes)


def serve_checked(tag, encode, search, batches, cfg, counts):
    """Serve ``batches`` sequentially, then pipelined, each run with the
    launch counts zeroed just before and read just after; checks that
    both runs launched each kernel of ``counts`` ((kernel, launches per
    request) pairs) that many times per request, and agree. Returns
    (results, the first kernel's launches in the pipelined run,
    sequential ms/request, pipelined ms/request, stats)."""
    import torch

    from repro_torch.launch import serving
    from repro_torch.launch.serve import serve_pipelined

    def zero():
        for fn, _ in counts:
            fn.launches = 0

    def read(run):
        for fn, n in counts:
            check(fn.launches == n * len(batches),
                  f"{tag}: the {run} run launched {fn.__name__} {fn.launches} times, "
                  f"want {n * len(batches)}")

    serving.warmup(encode, search, batches)
    zero()
    t0 = time.perf_counter()
    seq = serving.serve_sequential(encode, search, batches)
    dt_seq = time.perf_counter() - t0
    read("sequential")
    zero()
    t0 = time.perf_counter()
    results, stats, _ = serve_pipelined(encode, search, batches, cfg)
    dt_pipe = time.perf_counter() - t0
    read("pipelined")
    launches = counts[0][0].launches
    for (v, i), (sv, si) in zip(results, seq):
        check(v.shape == (SERVE_Q, K) and i.shape == (SERVE_Q, K), f"{tag}: bad shape")
        check(bool(torch.isfinite(v).all()), f"{tag}: non-finite scores")
        check(torch.equal(v, sv) and torch.equal(i, si),
              f"{tag}: pipelined results differ from serve_sequential")
    return (results, launches, 1e3 * dt_seq / len(batches), 1e3 * dt_pipe / len(batches),
            stats)


def bitwise_phase(d_codes, encode, batches, cfg, device, name, smi, sm_clock_mhz, sdc_ms):
    """Phase 8: FlatBitwise over the corpus codes. Returns the kernel's JSON row."""
    import torch

    from repro_torch.core.binarize_lib import coarse_codes, pack_code_planes
    from repro_torch.index.flat import FlatBitwise
    from repro_torch.kernels.binary_dot import kernel as bd_mod
    from repro_torch.kernels.binary_dot.ops import binary_dot_search_torch
    from repro_torch.kernels.binary_dot.ref import binary_dot_ref

    N = d_codes.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = FlatBitwise.build(d_codes, LEVELS, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(index.packed.shape == (N, LEVELS, CODE_DIM // 32), "bit planes have the wrong shape")
    check(torch.equal(index.packed[:4096].cpu(), pack_code_planes(d_codes[:4096].cpu(), LEVELS)),
          "bit planes packed on the card differ from the CPU's")
    log(f"[bitwise] FlatBitwise.build N={N} n_levels={LEVELS} m={CODE_DIM}: "
        f"{index.nbytes() / 1e9:.3f} GB of planes in {build_s:.3f} s")

    def search(q):
        return index.search(q, K)

    results, launches, seq_ms, pipe_ms, stats = serve_checked(
        "bitwise", encode, search, batches, cfg, [(bd_mod.binary_dot, 1)])
    for batch, (v, i) in zip(batches, results):
        check(bool(((i >= 0) & (i < N)).all()), "bitwise: ids out of range")
        qp = pack_code_planes(encode(batch), LEVELS)
        pv, pi = binary_dot_search_torch(qp, index.packed, m=CODE_DIM, k=K)
        check(torch.equal(v, pv) and torch.equal(i, pi),
              "bitwise: served search differs from the plain search")
    log(f"[bitwise] {len(batches)} requests of {SERVE_Q} served, {launches} binary_dot launches, "
        "bit-identical to serve_sequential and to the plain search")

    # the whole [Q, N] matrix at the main path's shapes, exactly
    qp = pack_code_planes(encode(batches[0]), LEVELS)
    s = bd_mod.binary_dot(qp, index.packed, m=CODE_DIM)
    ps = binary_dot_ref(qp, index.packed, CODE_DIM)
    check(s.shape == (SERVE_Q, N) and torch.equal(s, ps),
          f"binary_dot Q={SERVE_Q} N={N}: kernel != plain")
    err = float((s - ps).abs().max())
    del s, ps
    log(f"[bitwise] the full [{SERVE_Q}, {N}] binary_dot matrix exactly equal to the plain version")

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    popc_per_s = POPC_PER_SM_CLOCK * sms * sm_clock_mhz * 1e6
    q_codes = encode(batches[0])
    row = None
    for levels in (1, 2, LEVELS):
        qpl = pack_code_planes(coarse_codes(q_codes, LEVELS, levels), levels)
        dpl = (index.packed if levels == LEVELS
               else pack_code_planes(coarse_codes(d_codes, LEVELS, levels), levels))
        ms = cuda_ms(lambda: bd_mod.binary_dot(qpl, dpl, m=CODE_DIM), 5)
        words = levels * CODE_DIM // 32
        popc = SERVE_Q * N * levels * words
        nbytes = N * words * 4 + SERVE_Q * words * 4 + SERVE_Q * N * 4
        ops_ms, bytes_ms = 1e3 * popc / popc_per_s, 1e3 * nbytes / HBM_BYTES_PER_S
        plain = ""
        if levels == LEVELS:
            plain_ms = cuda_ms(lambda: binary_dot_ref(qpl, dpl, CODE_DIM), 1)
            plain = f", plain {plain_ms:.3f} ms"
            row = dict(
                name="binary_dot", route="cuda", source=BINARY_DOT_SOURCE,
                replaces=BINARY_DOT_REPLACES, launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=None,
            )
        del dpl
        log(f"[time] binary_dot n_levels={levels} Q={SERVE_Q} N={N} m={CODE_DIM} on {name} "
            f"({smi}): kernel {ms:.3f} ms{plain}, popc bound {ops_ms:.3f} ms "
            f"({popc / 1e9:.2f}e9 popc at {POPC_PER_SM_CLOCK}/SM/clock x {sms} SMs x "
            f"{sm_clock_mhz:.0f} MHz), HBM bound {bytes_ms:.3f} ms ({nbytes / 1e9:.2f} GB); "
            f"sdc_scores int8 on the same [{SERVE_Q}, {N}] {sdc_ms:.3f} ms, ratio "
            f"{ms / sdc_ms:.2f}; library none")
    log(f"[time] bitwise serving: sequential {seq_ms:.3f} ms/batch, pipelined {pipe_ms:.3f} "
        f"ms/batch (scan stage idle {100 * stats['device_idle_frac']:.0f}%), "
        f"{len(batches)} requests of {SERVE_Q} on {name} ({smi})")
    return row


def bigranular_phase(d_codes, encode, batches, cfg, device, name, smi, full_scan_ms):
    """Phase 8b: bi-granular retrieval over the corpus codes (coarse scan +
    fine rerank) through flat and IVF. Returns the rerank's two JSON rows."""
    import numpy as np
    import torch

    from repro_torch.core.binarize_lib import coarse_codes
    from repro_torch.index import ivf
    from repro_torch.index.flat import BiGranularFlat, flat_search_from_snapshot
    from repro_torch.kernels.sdc import gather as gather_mod
    from repro_torch.kernels.sdc import rerank as rr_mod
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.defaults import RERANK_GROUP
    from repro_torch.launch.serve import IVF_KMEANS_ITERS, IVF_NLIST, IVF_NPROBE, IVF_SEED

    t_phase = time.perf_counter()
    N = d_codes.shape[0]
    codes0 = encode(batches[0])
    flat_counts = [(gather_mod.sdc_gather_topk, 1), (sdc_mod.sdc_topk, 1)]
    serving_ms = {}

    def flat(codes, C, kc, backend="auto"):
        return flat_search_from_snapshot(codes, LEVELS, k=K, packed=True, backend=backend,
                                         rerank=dict(coarse_levels=C, k_coarse=kc),
                                         device=device)

    def served(tag, search, plain, counts):
        results, launches, seq_ms, pipe_ms, stats = serve_checked(
            f"bigranular {tag}", encode, search, batches, cfg, counts)
        for _, i in results:
            check(bool(((i >= 0) & (i < N)).all()), f"bigranular {tag}: ids out of range")
        v0, i0 = results[0]
        pv, pi = plain(codes0)
        check(torch.equal(v0, pv) and torch.equal(i0, pi),
              f"bigranular {tag}: served search differs from the plain version")
        serving_ms[tag] = (seq_ms, pipe_ms, stats["device_idle_frac"])
        log(f"[bigranular] {tag}: {len(batches)} requests of {SERVE_Q} served, launches "
            + ", ".join(f"{fn.__name__} {n * len(batches)}" for fn, n in counts)
            + " in each run; bit-identical to serve_sequential and to the plain version")
        return results, launches, float((v0 - pv).abs().max())

    # -- flat, the fine tier on the card --------------------------------------
    device_out = {}
    for C, kc in RERANK_CONFIGS:
        device_out[C, kc] = served(f"flat C={C} k'={kc}", flat(d_codes, C, kc),
                                   flat(d_codes, C, kc, backend="torch"), flat_counts)

    # -- flat, the fine tier in host memory ------------------------------------
    host = d_codes.cpu().numpy()
    t0 = time.perf_counter()
    search = flat(host, RERANK_C, RERANK_KC)
    torch.cuda.synchronize()
    host_build_s = time.perf_counter() - t0
    host_tag = f"flat C={RERANK_C} k'={RERANK_KC} host tier"
    host_out = served(host_tag, search, flat(d_codes, RERANK_C, RERANK_KC, backend="torch"),
                      flat_counts)
    for (v, i), (dv, di) in zip(host_out[0], device_out[RERANK_C, RERANK_KC][0]):
        check(torch.equal(v, dv) and torch.equal(i, di),
              "bigranular: the host tier's results differ from the device tier's")
    log(f"[bigranular] {host_tag}: bit-identical to the device tier on every request (built "
        f"from a {host.nbytes / 1e9:.2f} GB host copy in {host_build_s:.3f} s)")
    del search

    # -- k' past K_MAX: the coarse scan's unfused route -------------------------
    search = flat(d_codes, RERANK_C, RERANK_WIDE_KC)
    search(codes0)
    counters = (sdc_mod.sdc_topk, sdc_mod.sdc_scores, gather_mod.sdc_gather_topk)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, i = search(codes0)
    torch.cuda.synchronize()
    wide_ms = 1e3 * (time.perf_counter() - t0)
    topk_n, scores_n, gather_n = (fn.launches for fn in counters)
    check(topk_n == 0 and scores_n >= 1 and gather_n == 1,
          f"bigranular k'={RERANK_WIDE_KC}: launches sdc_topk {topk_n}, sdc_scores {scores_n}, "
          f"sdc_gather_topk {gather_n}; want 0, >= 1, 1")
    rows = slice(0, RERANK_WIDE_ROWS)
    pv, pi = flat(d_codes, RERANK_C, RERANK_WIDE_KC, backend="torch")(codes0[rows])
    check(torch.equal(v[rows], pv) and torch.equal(i[rows], pi),
          f"bigranular k'={RERANK_WIDE_KC} differs from the plain version")
    log(f"[bigranular] flat C={RERANK_C} k'={RERANK_WIDE_KC}: one request of {SERVE_Q} in "
        f"{wide_ms:.1f} ms, {scores_n} sdc_scores chunks and no sdc_topk for the coarse scan, "
        f"{gather_n} sdc_gather_topk for the rerank; queries 0-{RERANK_WIDE_ROWS - 1} equal "
        "to the plain version")
    del search

    # -- IVF: the coarse tier clustered at C levels -----------------------------
    def ivf_search(backend="auto"):
        return ivf.ivf_search_from_snapshot(
            d_codes, LEVELS, k=K, nlist=IVF_NLIST, nprobe=IVF_NPROBE, seed=IVF_SEED,
            kmeans_iters=IVF_KMEANS_ITERS, packed=True, backend=backend,
            rerank=dict(coarse_levels=RERANK_C, k_coarse=RERANK_KC), device=device)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search = ivf_search()
    torch.cuda.synchronize()
    ivf_build_s = time.perf_counter() - t0
    ivf_tag = f"IVF C={RERANK_C} k'={RERANK_KC} nprobe {IVF_NPROBE}"
    served(ivf_tag, search, ivf_search(backend="torch"),
           [(gather_mod.sdc_gather_topk, 2), (sdc_mod.sdc_topk, 0)])
    log(f"[bigranular] {ivf_tag}: built (k-means over {RERANK_C}-level codes) in "
        f"{ivf_build_s:.3f} s; one gather for the lists, one for the rerank, per request")
    del search

    # -- times ---------------------------------------------------------------------
    bigr = BiGranularFlat.build(d_codes, LEVELS, coarse_levels=RERANK_C, k_coarse=RERANK_KC,
                                packed=True, device=device)
    coarse = bigr.coarse
    qc = coarse_codes(codes0, LEVELS, RERANK_C)
    ck = dict(n_levels=RERANK_C, packed=True)
    coarse_ms = {k: cuda_ms(lambda k=k: sdc_mod.sdc_topk(qc, coarse.codes, coarse.inv_norm, k=k,
                                                         **ck), 20)
                 for k in (K, RERANK_KC)}
    scan_bytes = N * (coarse.codes.shape[1] + 4)
    log(f"[time] bigranular coarse scan C={RERANK_C} packed Q={SERVE_Q} N={N} on {name} ({smi}): "
        f"sdc_topk {coarse_ms[K]:.3f} ms at k={K}, {coarse_ms[RERANK_KC]:.3f} ms at "
        f"k'={RERANK_KC}; the full-level scan (n_levels {LEVELS}, k={K}) {full_scan_ms:.3f} ms; "
        f"both read {scan_bytes / 1e9:.3f} GB (a code a nibble at any level count; HBM bound "
        f"{1e3 * scan_bytes / HBM_BYTES_PER_S:.3f} ms); serialized coarse tier "
        f"{coarse.nbytes() / 1e9:.3f} GB against {N * ((CODE_DIM * LEVELS + 7) // 8 + 4) / 1e9:.3f}"
        " GB at full depth")

    _, cand = coarse.search(qc, RERANK_KC)
    live = int((cand >= 0).sum())
    W = sdc_mod.kernel_dim(CODE_DIM)
    qc_cap = gather_mod._pairs_per_block(W, False, sdc_mod.cap_for(K))

    def split(fn, probes, nlist):
        """(plan ms, scan, merge) of a gather call: the grouping of its
        pairs by list by CUDA events, the kernels by the profiler."""
        P = probes.numel()
        plan_ms = cuda_ms(lambda: gather_mod.gather_plan(probes, nlist, min(P, qc_cap)), 20)
        return (plan_ms, *device_ms(fn, 20, "gather_scan_kernel", "gather_merge_kernel"))

    def bound(nbytes):
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * 2 * live * CODE_DIM / INT8_OPS_PER_S
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    # the fine tier on the card: N lists of one row
    fine, fine_inv = bigr.fine_codes, bigr.fine_inv_norm
    rargs, rkw = (codes0, fine, fine_inv, cand), dict(n_levels=LEVELS, k=K)
    v, i = rr_mod.sdc_rerank(*rargs, **rkw)
    pv, pi = rr_mod.sdc_rerank_torch(*rargs, **rkw)
    check(torch.equal(v, pv) and torch.equal(i, pi), "sdc_rerank != sdc_rerank_torch")
    dev_ms = cuda_ms(lambda: rr_mod.sdc_rerank(*rargs, **rkw), 20)
    dev_plain_ms = cuda_ms(lambda: rr_mod.sdc_rerank_torch(*rargs, **rkw), 1)
    probes = rr_mod._sort_candidates(cand)
    dev_split = split(lambda: rr_mod.sdc_rerank(*rargs, **rkw), probes, N)
    P = probes.numel()
    dev_bytes = live * (CODE_DIM + 8) + codes0.numel() + 8 * P + SERVE_Q * K * 8
    dev_bound, dev_by = bound(dev_bytes)
    log(f"[time] rerank device tier C={RERANK_C} k'={RERANK_KC} Q={SERVE_Q} ({live} live "
        f"survivors) over N={N} lists of one row on {name} ({smi}): sdc_rerank {dev_ms:.4f} ms, "
        f"plain {dev_plain_ms:.3f} ms, bound {dev_bound:.4f} ms ({dev_by}; {dev_bytes / 1e6:.3f} "
        f"MB); split: plan (gather_plan over {N} lists) {dev_split[0]:.4f} ms, scan kernel "
        f"{dev_split[1]}, merge kernel {dev_split[2]} (profiler device time)")

    # the fine tier in host memory: survivors' rows gathered there, uploaded
    host_inv = fine_inv.cpu().numpy()
    g = RERANK_GROUP
    hargs = (codes0, host, host_inv, cand)
    hv, hi = rr_mod.sdc_rerank_gathered(*hargs, group=g, **rkw)
    check(torch.equal(hv, v) and torch.equal(hi, i), "sdc_rerank_gathered != sdc_rerank")
    whole_ms = host_ms(lambda: rr_mod.sdc_rerank_gathered(*hargs, group=g, **rkw), 20)
    parts = np.zeros(3)
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = rr_mod._sort_candidates(cand).cpu().numpy()
        t1 = time.perf_counter()
        safe = np.clip(c, 0, N - 1)
        rows_np = host[safe]
        inv_np = np.where(c >= 0, host_inv[safe], 0.0).astype(np.float32)
        t2 = time.perf_counter()
        for a in (rows_np, inv_np, c):
            torch.from_numpy(a).to(device)
        torch.cuda.synchronize()
        parts += (t1 - t0, t2 - t1, time.perf_counter() - t2)
    d2h_ms, gather_ms, upload_ms = 1e3 * parts / 20
    lists = rr_mod.host_gathered_lists(host, host_inv, cand, group=g, device=device)
    kv, ki = gather_mod.sdc_gather_topk(codes0, *lists, **rkw)
    kpv, kpi = gather_mod.sdc_gather_topk_torch(codes0, *lists, **rkw)
    check(torch.equal(kv, kpv) and torch.equal(ki, kpi),
          "the host-gathered rerank's kernel != plain")
    host_kernel_ms = cuda_ms(lambda: gather_mod.sdc_gather_topk(codes0, *lists, **rkw), 20)
    host_plain_ms = cuda_ms(lambda: gather_mod.sdc_gather_topk_torch(codes0, *lists, **rkw), 1)
    n_lists = lists[0].shape[0]
    host_split = split(lambda: gather_mod.sdc_gather_topk(codes0, *lists, **rkw), lists[3],
                       n_lists)
    host_bytes = n_lists * g * (CODE_DIM + 8) + codes0.numel() + 4 * lists[3].numel() \
        + SERVE_Q * K * 8
    host_bound, host_by = bound(host_bytes)
    log(f"[time] rerank host tier C={RERANK_C} k'={RERANK_KC} Q={SERVE_Q} group {g} on {name} "
        f"({smi}): sdc_rerank_gathered {whole_ms:.4f} ms a call (host clock, synchronised): "
        f"candidates to the host {d2h_ms:.4f} ms, host gather {gather_ms:.4f} ms, upload "
        f"{upload_ms:.4f} ms; kernel on the [{n_lists}, {g}] lists {host_kernel_ms:.4f} ms "
        f"(plan {host_split[0]:.4f} ms, scan kernel {host_split[1]}, merge kernel "
        f"{host_split[2]}), plain {host_plain_ms:.3f} ms, bound {host_bound:.4f} ms ({host_by}; "
        f"{host_bytes / 1e6:.3f} MB)")
    for tag, (seq_ms, pipe_ms, idle) in serving_ms.items():
        log(f"[time] bigranular serving {tag}: sequential {seq_ms:.3f} ms/batch, pipelined "
            f"{pipe_ms:.3f} ms/batch (scan stage idle {100 * idle:.0f}%), {len(batches)} "
            f"requests of {SERVE_Q} on {name} ({smi})")
    log(f"[bigranular] phase passed in {time.perf_counter() - t_phase:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    _, dev_launches, dev_err = device_out[RERANK_C, RERANK_KC]
    return [
        dict(name="sdc_gather_topk_rerank", route="cuda", source=GATHER_SOURCE,
             replaces=GATHER_REPLACES, launches=dev_launches, max_abs_err=dev_err, ms=dev_ms,
             plain_ms=dev_plain_ms, bound_ms=dev_bound, bound_by=dev_by, library_ms=None),
        dict(name="sdc_gather_topk_rerank_gathered", route="cuda", source=GATHER_SOURCE,
             replaces=GATHER_REPLACES, launches=host_out[1], max_abs_err=host_out[2],
             ms=host_kernel_ms, plain_ms=host_plain_ms, bound_ms=host_bound, bound_by=host_by,
             library_ms=None),
    ]


def hnsw_phase(model, encode, cfg, seed, device, name, smi):
    """Phase 8c: the HNSW graph search at the CLI's width. Returns its gather's JSON row."""
    import numpy as np
    import torch

    from repro_torch.core.binarize_lib import coarse_codes, pack_codes_nibbles
    from repro_torch.data.synthetic import clustered_corpus
    from repro_torch.index import hnsw_lite as hl
    from repro_torch.kernels.sdc import gather as gather_mod
    from repro_torch.kernels.sdc import ref as sdc_ref
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ops import sdc_search_backend
    from repro_torch.kernels.sdc.rerank import sdc_rerank_backend
    from repro_torch.launch import serving
    from repro_torch.launch.serve import (HNSW_EF_CONSTRUCTION, HNSW_M, HNSW_MAX_HOPS,
                                          HNSW_SEED, encode_codes, recall_at_k,
                                          serve_pipelined)

    t_phase = time.perf_counter()
    n_queries = SERVE_Q * SERVE_REQUESTS
    docs, queries, gt = clustered_corpus(seed, HNSW_DOCS, n_queries, DIM)
    d_codes = encode_codes(model, torch.from_numpy(docs).to(device))
    batches = [torch.from_numpy(queries[i:i + SERVE_Q]).to(device)
               for i in range(0, n_queries, SERVE_Q)]
    codes_b = [encode(b) for b in batches]
    host = d_codes.cpu().numpy()
    inv = sdc_ref.doc_inv_norms(d_codes, LEVELS).cpu().numpy()
    N = host.shape[0]
    gkw = dict(M=HNSW_M, ef_construction=HNSW_EF_CONSTRUCTION, seed=HNSW_SEED)
    skw = dict(k=K, ef=HNSW_EF, beam=HNSW_BEAM, max_hops=HNSW_MAX_HOPS)

    # -- the host build and the device tables, int8 and packed -----------------
    graphs, tables, build_s, prep_s = {}, {}, {}, {}
    for packed in (False, True):
        t0 = time.perf_counter()
        graphs[packed] = hl.build_hnsw(host, inv, n_levels=LEVELS, packed=packed, **gkw)
        build_s[packed] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables[packed] = hl.prepare_batched(graphs[packed], device=device)
        torch.cuda.synchronize()
        prep_s[packed] = time.perf_counter() - t0
    g = graphs[False]
    check(np.array_equal(g.neighbors, graphs[True].neighbors) and g.entry == graphs[True].entry,
          "hnsw: two builds from the same codes and seed differ")
    check(np.array_equal(graphs[True].codes, pack_codes_nibbles(torch.from_numpy(host)).numpy()),
          "hnsw: the packed build's codes are not the packed codes")
    check(int(g.neighbors.min()) >= -1 and int(g.neighbors.max()) < N,
          "hnsw: neighbour ids out of range")
    for f in ("codes", "nbr_codes"):
        check(torch.equal(getattr(tables[True], f), pack_codes_nibbles(getattr(tables[False], f))),
              f"hnsw: packed {f} differ from the packed int8 tables")
    for f in ("inv_norm", "nbr_inv", "nbr_ids"):
        check(torch.equal(getattr(tables[True], f), getattr(tables[False], f)),
              f"hnsw: packed tables differ in {f}")
    log(f"[hnsw] build_hnsw N={N} D={CODE_DIM} M={HNSW_M} ef_construction="
        f"{HNSW_EF_CONSTRUCTION} on the host: int8 {build_s[False]:.2f} s, packed "
        f"{build_s[True]:.2f} s (identical graphs, {int((g.neighbors < 0).sum())} empty slots); "
        f"prepare_batched int8 {prep_s[False]:.3f} s, packed {prep_s[True]:.3f} s; device tables "
        f"int8 {tables[False].nbytes() / 2**20:.2f} MiB, packed {tables[True].nbytes() / 2**20:.2f}"
        f" MiB (the M-fold neighbour blocks) against HNSWLite.nbytes int8 "
        f"{g.nbytes() / 2**20:.2f} MiB, packed {graphs[True].nbytes() / 2**20:.2f} MiB")

    topk_fn, gather_fn, walk = sdc_mod.sdc_topk, gather_mod.sdc_gather_topk, hl.hnsw_frontier_search

    def hop_counts(tbl, codes, **kw):
        """Each request's walk: its stats, gather launches (the hops in
        which some query is active) and host reads (one a hop, and one
        more that finds no query active, unless the budget ends it)."""
        stats = [hl.search_hnsw_batched(tbl, c, with_stats=True, **kw)[2] for c in codes]
        iters = [int(s["hops"].max()) for s in stats]
        return stats, iters, [n + (n < HNSW_MAX_HOPS) for n in iters]

    def served(tag, search, plain, want_gather, want_reads, codes):
        """Both drivers, launch counts and host reads zeroed just before and
        read just after each run; every request held against ``plain``."""
        serving.warmup(encode, search, batches)
        want = (len(batches), sum(want_gather), sum(want_reads))

        def zero():
            topk_fn.launches = gather_fn.launches = walk.host_reads = 0

        def read(run):
            got = (topk_fn.launches, gather_fn.launches, walk.host_reads)
            check(got == want, f"hnsw {tag}: the {run} run counted (sdc_topk, sdc_gather_topk, "
                               f"host reads) = {got}, want {want}")

        zero()
        t0 = time.perf_counter()
        seq = serving.serve_sequential(encode, search, batches)
        dt_seq = time.perf_counter() - t0
        read("sequential")
        zero()
        t0 = time.perf_counter()
        results, stats, _ = serve_pipelined(encode, search, batches, cfg)
        dt_pipe = time.perf_counter() - t0
        read("pipelined")
        err = 0.0
        for c, (v, i), (sv, si) in zip(codes, results, seq):
            check(v.shape == (SERVE_Q, K) and i.shape == (SERVE_Q, K), f"hnsw {tag}: bad shape")
            check(bool(torch.isfinite(v).all()), f"hnsw {tag}: non-finite scores")
            check(bool(((i >= 0) & (i < N)).all()), f"hnsw {tag}: ids out of range")
            check(all(len(set(r)) == K for r in i.tolist()), f"hnsw {tag}: an id twice in a row")
            check(torch.equal(v, sv) and torch.equal(i, si),
                  f"hnsw {tag}: pipelined results differ from serve_sequential")
            pv, pi = plain(c)
            check(torch.equal(v, pv) and torch.equal(i, pi),
                  f"hnsw {tag}: served search differs from the plain version")
            err = max(err, float((v - pv).abs().max()))
        log(f"[hnsw] {tag}: {len(batches)} requests of {SERVE_Q} served, {want[0]} sdc_topk and "
            f"{want[1]} sdc_gather_topk launches and {want[2]} host reads in each run; "
            "bit-identical to serve_sequential and to the plain version on every request")
        return dict(results=results, gathers=want[1], err=err, seq_ms=1e3 * dt_seq / len(batches),
                    pipe_ms=1e3 * dt_pipe / len(batches), idle=stats["device_idle_frac"])

    # -- served, int8 and packed ---------------------------------------------------
    stats, iters, reads = hop_counts(tables[False], codes_b, **skw)
    out = {}
    for packed in (False, True):
        tag = "packed" if packed else "int8"
        tbl = tables[packed]
        out[tag] = served(
            tag, lambda q, tbl=tbl: hl.search_hnsw_batched(tbl, q, **skw),
            lambda c, tbl=tbl: hl.search_hnsw_batched(tbl, c, backend="torch", **skw),
            iters, reads, codes_b)
    for (v, i), (pv, pi) in zip(out["int8"]["results"], out["packed"]["results"]):
        check(torch.equal(v, pv) and torch.equal(i, pi), "hnsw: packed and int8 results differ")
    hops = torch.cat([s["hops"] for s in stats]).float()
    scored = torch.cat([s["scored"] for s in stats]).float()
    log(f"[hnsw] packed and int8 bit-identical; hops per query mean {float(hops.mean()):.2f} max "
        f"{int(hops.max())}; hop iterations per request {iters}; scored candidates per query "
        f"mean {float(scored.mean()):.1f}; host reads per request mean {np.mean(reads):.2f}")

    # -- bi-granular: the walk at C levels, the fine tier in host memory --------
    C, kc = HNSW_RERANK
    rerank = dict(coarse_levels=C, k_coarse=kc)
    t0 = time.perf_counter()
    search = hl.hnsw_search_from_snapshot(host, LEVELS, packed=True, rerank=rerank, device=device,
                                          **gkw, **skw)
    torch.cuda.synchronize()
    bigr_s = time.perf_counter() - t0
    codes_c = coarse_codes(d_codes, LEVELS, C)
    graph_c = hl.build_hnsw(codes_c.cpu().numpy(), sdc_ref.doc_inv_norms(codes_c, C).cpu().numpy(),
                            n_levels=C, packed=True, **gkw)
    tables_c = hl.prepare_batched(graph_c, device=device)
    ckw = dict(skw, k=kc, ef=max(kc, HNSW_EF))
    qc_b = [coarse_codes(c, LEVELS, C) for c in codes_b]
    _, iters_c, reads_c = hop_counts(tables_c, qc_b, **ckw)

    def bigr_plain(c):
        _, cand = hl.search_hnsw_batched(tables_c, coarse_codes(c, LEVELS, C), backend="torch",
                                         **ckw)
        return sdc_rerank_backend(c, host, inv, cand, n_levels=LEVELS, k=K, backend="torch")

    bigr_tag = f"C={C} k'={kc} host tier"
    out[bigr_tag] = served(bigr_tag, search, bigr_plain, [n + 1 for n in iters_c], reads_c,
                           codes_b)
    log(f"[hnsw] {bigr_tag}: hnsw_search_from_snapshot built in {bigr_s:.2f} s; a walk at ef "
        f"{ckw['ef']} over {C}-level packed codes ({tables_c.nbytes() / 2**20:.2f} MiB of tables), "
        f"hop iterations per request {iters_c}, then one gather for the rerank")
    del search

    # -- the full hop budget, held against the early exit ------------------------
    tbl = tables[False]
    topk_fn.launches = gather_fn.launches = walk.host_reads = 0
    v, i, s = hl.search_hnsw_batched(tbl, codes_b[0], with_stats=True, early_exit=False, **skw)
    got = (topk_fn.launches, gather_fn.launches, walk.host_reads)
    check(got == (1, HNSW_MAX_HOPS, 0),
          f"hnsw full budget: counted (sdc_topk, gather, host reads) = {got}, want (1, "
          f"{HNSW_MAX_HOPS}, 0)")
    v0, i0 = out["int8"]["results"][0]
    check(torch.equal(v, v0) and torch.equal(i, i0) and torch.equal(s["hops"], stats[0]["hops"])
          and torch.equal(s["scored"], stats[0]["scored"]),
          "hnsw: the full hop budget differs from the early exit")
    log(f"[hnsw] request 0 at the full budget ({HNSW_MAX_HOPS} gathers, no host read) "
        f"bit-identical to its early exit after {iters[0]} hops, stats included")

    # -- a beam holding doc 0 beside invalid slots (every invalid slot clamps to 0)
    cpu_tbl = hl.prepare_batched(g, device="cpu")
    holder = next(int(n) for n in np.nonzero((g.neighbors == 0).any(1))[0] if n != 0)
    for first in (0, holder):
        ents = torch.tensor([first] + [-1] * 7)

        def walk_from(t, q, backend):
            return walk(q, t.codes, t.inv_norm, t.nbr_codes, t.nbr_inv, t.nbr_ids, ents,
                        n_levels=LEVELS, k=K, ef=HNSW_EF, beam=HNSW_BEAM,
                        max_hops=HNSW_MAX_HOPS, backend=backend, packed=False)

        want = walk_from(cpu_tbl, codes_b[0].cpu(), "torch")
        for backend in ("auto", "torch"):
            got = walk_from(tbl, codes_b[0], backend)
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got[:2], want[:2]))
                  and all(torch.equal(got[2][x].cpu(), want[2][x]) for x in ("hops", "scored")),
                  f"hnsw from entry {first} alone ({backend}): differs from the plain version "
                  "on the CPU")
        check(all(len(set(r) - {-1}) == sum(x >= 0 for x in r) for r in want[1].tolist()),
              f"hnsw from entry {first} alone: an id twice in a row")
    log(f"[hnsw] walks from doc 0 alone and from doc {holder} (doc 0 among its neighbours) "
        "alone, beside 7 invalid entries: the kernel and the plain version on the card equal "
        "the plain version on the CPU, stats included")

    # -- times: one hop split at the state of hop HNSW_SPLIT_HOP of request 0 ---
    q = codes_b[0]
    Q = q.shape[0]
    E = 8
    ents = hl._entry_points(N, g.entry, E, 0)
    ents_t = torch.full((E,), -1, dtype=torch.int64)
    ents_t[:len(ents)] = torch.from_numpy(ents)
    ents_t = ents_t.to(device)
    e_valid = ents_t >= 0
    e_ids = torch.where(e_valid, ents_t, 0)

    def entry_scoring():
        e_inv = torch.where(e_valid, tbl.inv_norm[e_ids], 0.0)
        return sdc_search_backend(q, tbl.codes[e_ids], e_inv, n_levels=LEVELS, k=HNSW_EF)

    res_vals, e_pos = entry_scoring()
    res_ids = torch.where(e_pos >= 0, ents_t[e_pos.clamp(0, E - 1).long()], -1).int()
    visited = torch.zeros((Q, N + 1), dtype=torch.bool, device=device)
    visited[:, torch.where(e_valid, ents_t, N)] = True
    expanded = torch.zeros_like(visited)
    active = torch.ones(Q, dtype=torch.bool, device=device)
    gkw_hop = dict(n_levels=LEVELS, k=HNSW_EF)
    check(iters[0] > HNSW_SPLIT_HOP, f"hnsw: request 0 ended before hop {HNSW_SPLIT_HOP}")
    for hop in range(HNSW_SPLIT_HOP + 1):
        beam_ids = hl.select_beam(res_vals, res_ids, expanded, HNSW_BEAM)
        active &= (beam_ids >= 0).any(-1)
        state = (expanded.clone(), visited.clone())
        bclamp, fresh = hl.expand_beam(beam_ids, active, tbl.nbr_ids, expanded, visited)
        mask = fresh.reshape(Q, HNSW_BEAM, HNSW_M).float()
        gargs = (q, tbl.nbr_codes, tbl.nbr_inv, tbl.nbr_ids, bclamp)
        hop_vals, hop_ids = gather_fn(*gargs, cand_mask=mask, **gkw_hop)
        merged = sdc_mod.merge_running_topk(res_vals, res_ids, hop_vals, hop_ids, HNSW_EF)
        if hop < HNSW_SPLIT_HOP:
            res_vals, res_ids = merged
    pv, pi = gather_mod.sdc_gather_topk_torch(*gargs, cand_mask=mask, **gkw_hop)
    check(torch.equal(hop_vals, pv) and torch.equal(hop_ids, pi),
          f"hnsw hop {HNSW_SPLIT_HOP}: gather kernel != plain")
    exp_t, vis_t = state
    qc_cap = gather_mod._pairs_per_block(sdc_mod.kernel_dim(CODE_DIM), False,
                                         sdc_mod.cap_for(HNSW_EF))
    split = {
        "entry scoring": cuda_ms(entry_scoring, 50),
        "beam selection": cuda_ms(lambda: hl.select_beam(res_vals, res_ids, exp_t, HNSW_BEAM),
                                  50),
        "dedupe": cuda_ms(lambda: hl.expand_beam(beam_ids, active, tbl.nbr_ids, exp_t.clone(),
                                                 vis_t.clone()), 50),
        "plan": cuda_ms(lambda: gather_mod.gather_plan(bclamp, N, min(bclamp.numel(), qc_cap)),
                        50),
        "gather call": cuda_ms(lambda: gather_fn(*gargs, cand_mask=mask, **gkw_hop), 50),
        "merge": cuda_ms(lambda: sdc_mod.merge_running_topk(res_vals, res_ids, hop_vals, hop_ids,
                                                            HNSW_EF), 50),
    }
    clone_ms = cuda_ms(lambda: (exp_t.clone(), vis_t.clone()), 50)
    split["dedupe"] -= clone_ms
    scan_ms, merge_ms = device_ms(lambda: gather_fn(*gargs, cand_mask=mask, **gkw_hop), 50,
                                  "gather_scan_kernel", "gather_merge_kernel")
    plain_ms = cuda_ms(lambda: gather_mod.sdc_gather_topk_torch(*gargs, cand_mask=mask,
                                                                **gkw_hop), 5)
    beam_ok = (beam_ids >= 0) & active[:, None]
    lists = int(torch.unique(bclamp[beam_ok]).numel())
    live = int(fresh.sum())
    nbytes = (lists * HNSW_M * (CODE_DIM + 8) + mask.numel() * 4 + q.numel() + bclamp.numel() * 8
              + Q * HNSW_EF * 8)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * live * CODE_DIM / INT8_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    hop_ms = sum(v for k_, v in split.items() if k_ not in ("entry scoring", "plan"))
    log(f"[time] hnsw hop {HNSW_SPLIT_HOP} of request 0, Q={Q} beam={HNSW_BEAM} M={HNSW_M} "
        f"ef={HNSW_EF} N={N} int8 on {name} ({smi}): "
        + ", ".join(f"{k_} {v:.4f} ms" for k_, v in split.items())
        + f" (CUDA events; the dedupe without its two bitmap copies, {clone_ms:.4f} ms); gather "
        f"scan kernel {scan_ms}, merge kernel {merge_ms} (profiler device time); a hop "
        f"{hop_ms:.4f} ms; gather plain {plain_ms:.3f} ms; bound {bound_ms:.6f} ms ("
        f"{'bytes' if bytes_ms >= ops_ms else 'operations'}: {lists} distinct beam nodes, "
        f"{live} fresh slots, {nbytes / 1e6:.3f} MB; int8 ops {ops_ms:.3g} ms)")
    tbl_p = tables[True]
    for tag, t_ in (("int8", tbl), ("packed", tbl_p)):
        def request(t_=t_):
            return hl.search_hnsw_batched(t_, q, **skw)

        wall = host_ms(request, 10)
        busy = device_busy_ms(request, 3)
        share = "not measured" if isinstance(busy, str) else f"{100 * (1 - busy / wall):.1f}%"
        log(f"[time] hnsw search of request 0 ({iters[0]} hops) {tag} on {name} ({smi}): "
            f"{wall:.3f} ms (host clock, synchronised), device busy "
            f"{busy if isinstance(busy, str) else f'{busy:.4f} ms'} (profiler, every kernel), "
            f"device idle {share}; {wall / iters[0]:.4f} ms per hop iteration")
    for tag, o in out.items():
        log(f"[time] hnsw serving {tag}: sequential {o['seq_ms']:.3f} ms/batch, pipelined "
            f"{o['pipe_ms']:.3f} ms/batch (scan stage idle {100 * o['idle']:.0f}%), "
            f"{len(batches)} requests of {SERVE_Q} on {name} ({smi})")
    idx = torch.cat([i for _, i in out["int8"]["results"]], 0)
    idx_c = torch.cat([i for _, i in out[bigr_tag]["results"]], 0)
    log(f"[hnsw] recall@{K} against the positive doc (untrained weights, information only): "
        f"hnsw {recall_at_k(idx, gt):.4f}, bi-granular {recall_at_k(idx_c, gt):.4f}")
    log(f"[hnsw] phase passed in {time.perf_counter() - t_phase:.1f} s")
    return dict(name="sdc_gather_topk_hnsw", route="cuda", source=GATHER_SOURCE,
                replaces=GATHER_REPLACES, launches=out["int8"]["gathers"],
                max_abs_err=out["int8"]["err"], ms=split["gather call"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


def dlrm_phase(seed, device, name, smi):
    """Phase 9: the dlrm-rm2 serving forward at full width. Returns the kernel's JSON row."""
    import torch

    from repro_torch.configs.archs.dlrm_rm2 import CONFIG
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.kernels.dot_interact import kernel as di_mod
    from repro_torch.kernels.dot_interact.ref import (
        dot_interact_ref,
        dot_interact_torch,
        tril_indices,
    )
    from repro_torch.models.recsys.dlrm import init_dlrm
    from repro_torch.train.steps import dlrm_serve_step

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_dlrm(CONFIG, torch.Generator(device=device).manual_seed(seed), device)
    torch.cuda.synchronize()
    log(f"[dlrm] {CONFIG.name}: {CONFIG.n_sparse} tables of {CONFIG.table_vocab} x "
        f"{CONFIG.embed_dim} f32 ({model.tables.numel() * 4 / 1e9:.2f} GB), bot {CONFIG.bot_mlp}, "
        f"top {CONFIG.top_dims}, {CONFIG.param_count()} parameters, made on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    step = dlrm_serve_step(CONFIG)
    batches = {shape: [dlrm_batch(s, B, CONFIG, device) for s in range(DLRM_BATCHES)]
               for shape, B in DLRM_SHAPES}
    for shape, bs in batches.items():
        step(model, bs[0])  # warm up
    torch.cuda.synchronize()
    di_mod.dot_interact.launches = 0
    logits, step_ms = {}, {}
    for shape, bs in batches.items():
        t0 = time.perf_counter()
        logits[shape] = [step(model, b) for b in bs]
        torch.cuda.synchronize()
        step_ms[shape] = 1e3 * (time.perf_counter() - t0) / len(bs)
    launches = di_mod.dot_interact.launches
    want = sum(len(bs) for bs in batches.values())
    check(launches == want, f"dlrm: the served batches launched dot_interact {launches} times, "
          f"want {want}")

    err = 0.0
    with torch.no_grad():
        for shape, B in DLRM_SHAPES:
            gram_err = 0.0
            for b, lg in zip(batches[shape], logits[shape]):
                check(lg.shape == (B,) and bool(torch.isfinite(lg).all()),
                      f"dlrm {shape}: logits not finite or of the wrong shape")
                x, feats = model.features(b["dense"], b["sparse_ids"])
                ker, plain = di_mod.dot_interact(feats), dot_interact_torch(feats)
                check(torch.equal(ker, plain), f"dlrm {shape}: dot_interact kernel != plain")
                err = max(err, float((ker - plain).abs().max()))
                check(torch.equal(lg, model.top_logits(plain, x)),
                      f"dlrm {shape}: logits differ from the forward with the plain interaction")
                gram = model(b["dense"], b["sparse_ids"], interact_fn=dot_interact_ref)
                gram_err = max(gram_err, float((lg - gram).abs().max()))
                check(gram_err <= 1e-4 * (1 + float(lg.abs().max())),
                      f"dlrm {shape}: logits differ from the Gram-matrix forward by {gram_err}")
            log(f"[dlrm] {shape} B={B}: {DLRM_BATCHES} batches served, logits finite; "
                "dot_interact exactly equal to the plain version and the logits to the forward "
                f"with the plain interaction; max |logits - Gram-matrix forward| {gram_err:.3g}; "
                f"{step_ms[shape]:.3f} ms/batch (host clock, synchronised)")

    F, D = CONFIG.n_feat, CONFIG.embed_dim
    P = F * (F - 1) // 2
    rows, cols = tril_indices(F, device)
    row = None
    for shape, B in DLRM_SHAPES:
        with torch.no_grad():
            _, feats = model.features(batches[shape][0]["dense"], batches[shape][0]["sparse_ids"])
        reps = 20 if B > 4096 else 200
        ms = cuda_ms(lambda: di_mod.dot_interact(feats), reps)
        dev_ms = device_ms(lambda: di_mod.dot_interact(feats), reps, "dot_interact_kernel")
        plain_ms = cuda_ms(lambda: dot_interact_torch(feats), 2 if B > 4096 else 20)
        library_ms = cuda_ms(lambda: torch.bmm(feats, feats.transpose(1, 2))[:, rows, cols],
                             reps)
        nbytes = B * F * D * 4 + B * P * 4
        flops = 2 * B * P * D
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS_PER_S
        if B == max(b for _, b in DLRM_SHAPES):
            row = dict(
                name="dot_interact", route="cuda", source=DOT_INTERACT_SOURCE,
                replaces=DOT_INTERACT_REPLACES, launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=library_ms,
            )
        log(f"[time] dot_interact {shape} B={B} F={F} D={D} on {name} ({smi}): kernel "
            f"{ms:.4f} ms (profiler device time {dev_ms}), plain {plain_ms:.3f} ms, HBM bound "
            f"{bytes_ms:.4f} ms "
            f"({nbytes / 1e9:.3f} GB), fp32 op bound {ops_ms:.4f} ms, library (torch.bmm + "
            f"triangle) {library_ms:.4f} ms{'' if B > 4096 else '; input L2-resident'}")
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=10_000_037)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run chip_smoke.py from a checkout of the repo")
    sys.path.insert(0, SRC)

    from repro_torch.core.binarize_lib import BinarizerConfig, init_binarizer, make_encode_fn
    from repro_torch.data.synthetic import clustered_corpus_torch
    from repro_torch.index.flat import FlatFloat, FlatSDC
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ops import sdc_search_torch
    from repro_torch.launch import serving
    from repro_torch.launch.serve import encode_codes, recall_at_k, serve_pipelined

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)

    # -- build every kernel, one nvcc per source, all at once ------------
    t0 = time.perf_counter()
    libs = _build.build(_build.SOURCES)
    log(f"[build] {len(libs)} CUDA libraries in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        kernel = "?"
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '.*?((?:sdc|gather)_(?:scan|merge|scores)_kernel)"
                          r"(?:ILi(\d+)ELb([01])E(?:Lb([01])E)?|ILb([01])ELb([01])E)?", line)
            b = re.search(r"Compiling entry function '.*?(binary_dot_kernel)ILi(\d+)ELi(\d+)E"
                          r"|Compiling entry function '.*?(dot_interact_kernel)", line)
            if m and m.group(5):  # sdc_scores: any D, packed or not, D <= 256 or above
                kernel = (f"{m.group(1)}{' packed' if m.group(5) == '1' else ''} "
                          f"{'D <= 256' if m.group(6) == '1' else 'D > 256'}")
            elif m:
                kernel = m.group(1) + (f" D={m.group(2)}{' packed' if m.group(3) == '1' else ''}"
                                       f"{' masked' if m.group(4) == '1' else ''}"
                                       if m.group(2) else "")
            elif b:
                kernel = (f"{b.group(1)} n_levels={b.group(2)} m={32 * int(b.group(3))}"
                          if b.group(1) else b.group(4))
            elif "registers" in line or "spill" in line:
                log(f"[build]   {kernel}: {line.replace('ptxas info    :', '').strip()}")

    # -- 1. device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    log(f"[device] {name} x{count}; {smi}; max SM clock {sm_clock_mhz:.0f} MHz; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. kernel vs plain, edge cases -----------------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    n_cases = edge_cases(device, gen)
    padded_requests(device, gen)
    log(f"[edge] {n_cases} cases exactly equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_gather = gather_edge_cases(device, gen)
    n_scores = scores_edge_cases(device, gen)
    n_dot = dot_interact_edge_cases(device, gen)
    log(f"[gather-edge] {n_gather} gather, {n_scores} sdc_scores and {n_dot} dot_interact cases "
        f"exactly equal to the plain versions ({time.perf_counter() - t0:.1f} s)")

    # -- 3. the main path at full width -----------------------------------
    t0 = time.perf_counter()
    n_queries = SERVE_Q * SERVE_REQUESTS
    docs, queries, gt = clustered_corpus_torch(args.seed, args.docs, n_queries, DIM,
                                               device=device)
    bcfg = BinarizerConfig(input_dim=DIM, code_dim=CODE_DIM, n_levels=LEVELS,
                           hidden_dim=2 * DIM)
    model = init_binarizer(bcfg, torch.Generator(device=device).manual_seed(args.seed),
                           device)
    d_codes = encode_codes(model, docs, batch=1 << 17)
    flat_float = FlatFloat.build(docs, device=device)
    del docs
    indexes = {p: FlatSDC.build(d_codes, LEVELS, packed=p, device=device)
               for p in (False, True)}
    torch.cuda.synchronize()
    log(f"[main] corpus {args.docs} x {DIM} on the card, encoded and indexed in "
        f"{time.perf_counter() - t0:.1f} s; int8 codes "
        f"{d_codes.numel() / 1e9:.2f} GB, packed {indexes[True].codes.numel() / 1e9:.2f} GB, "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    check(d_codes.shape == (args.docs, CODE_DIM), "codes have the wrong shape")
    check(int(d_codes.min()) >= 0 and int(d_codes.max()) < 2**LEVELS, "codes out of range")

    # the encoder on the card against the same weights on the CPU
    probe = queries[:SERVE_Q]
    enc_gpu = make_encode_fn(model)(probe).cpu()
    cpu_model = init_binarizer(bcfg, torch.Generator().manual_seed(args.seed), "cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    enc_cpu = make_encode_fn(cpu_model)(probe.cpu())
    flips = int((enc_gpu != enc_cpu).sum())
    check(flips <= 1e-3 * enc_cpu.numel(), f"card and CPU codes differ in {flips} entries")
    log(f"[main] encoder: card vs CPU codes differ in {flips}/{enc_cpu.numel()} entries")

    encode = make_encode_fn(model)
    batches = [queries[i:i + SERVE_Q] for i in range(0, n_queries, SERVE_Q)]
    cfg = serving.ServingConfig(queue_depth=4, policy="block")
    served, report = {}, {}
    for packed, index in indexes.items():
        tag = "packed" if packed else "int8"
        search = lambda q, index=index: index.search(q, K)  # noqa: E731
        serving.warmup(encode, search, batches)

        sdc_mod.sdc_topk.launches = 0
        t0 = time.perf_counter()
        seq = serving.serve_sequential(encode, search, batches)
        dt_seq = time.perf_counter() - t0
        check(sdc_mod.sdc_topk.launches == len(batches),
              f"{tag}: sequential run launched the kernel {sdc_mod.sdc_topk.launches} times")

        sdc_mod.sdc_topk.launches = 0
        t0 = time.perf_counter()
        results, stats, _ = serve_pipelined(encode, search, batches, cfg)
        dt_pipe = time.perf_counter() - t0
        launches = sdc_mod.sdc_topk.launches
        check(launches == len(batches),
              f"{tag}: the served requests launched the kernel {launches} times, "
              f"want {len(batches)}")

        for (v, i), (sv, si) in zip(results, seq):
            check(v.shape == (SERVE_Q, K) and i.shape == (SERVE_Q, K), f"{tag}: bad shape")
            check(bool(torch.isfinite(v).all()), f"{tag}: non-finite scores")
            check(bool(((i >= 0) & (i < args.docs)).all()), f"{tag}: ids out of range")
            check(torch.equal(v, sv) and torch.equal(i, si),
                  f"{tag}: pipelined results differ from serve_sequential")
        codes0 = encode(batches[0])
        pv, pi = sdc_search_torch(codes0, index.codes, index.inv_norm, n_levels=LEVELS, k=K,
                                  packed=packed)
        v0, i0 = results[0]
        check(torch.equal(v0, pv) and torch.equal(i0, pi),
              f"{tag}: served search differs from the plain version")
        served[packed] = results
        report[packed] = dict(launches=launches, err=float((v0 - pv).abs().max()),
                              seq_ms=1e3 * dt_seq / len(batches),
                              pipe_ms=1e3 * dt_pipe / len(batches),
                              idle=stats["device_idle_frac"], codes=codes0)
        log(f"[main] {tag}: {len(batches)} requests of {SERVE_Q} served, {launches} kernel "
            "launches, bit-identical to serve_sequential and to the plain version")
    for (a, b), (c, d) in zip(served[False], served[True]):
        check(torch.equal(a, c) and torch.equal(b, d), "packed and int8 results differ")
    log("[main] packed and int8 results bit-identical")

    _, idx_f = flat_float.search(queries, K)
    idx_b = torch.cat([i for _, i in served[False]], 0)
    log(f"[main] recall@{K} against the positive doc (untrained weights, information "
        f"only): float={recall_at_k(idx_f, gt.cpu()):.4f} BEBR={recall_at_k(idx_b, gt.cpu()):.4f}")
    del flat_float, idx_f

    # -- 3b. the IVF serving path at full width -----------------------------
    import numpy as np

    from repro_torch.core.binarize_lib import pack_codes_nibbles
    from repro_torch.index import ivf
    from repro_torch.kernels.sdc import gather as gather_mod
    from repro_torch.kernels.sdc import ops as ops_mod
    from repro_torch.launch.serve import IVF_KMEANS_ITERS, IVF_NLIST, IVF_NPROBE, IVF_SEED

    def build_ivf(packed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        index = ivf.build_ivf(d_codes, n_levels=LEVELS, nlist=IVF_NLIST,
                              kmeans_iters=IVF_KMEANS_ITERS, seed=IVF_SEED, packed=packed,
                              device=device)
        torch.cuda.synchronize()
        return index, time.perf_counter() - t

    fields = ("centroids", "centroid_codes", "lists_codes", "lists_inv_norm", "lists_ids")
    ivfs, build_s = {}, {}
    ivfs[False], build_s["int8"] = build_ivf(False)
    again, build_s["int8 again"] = build_ivf(False)
    for f in fields:
        check(torch.equal(getattr(ivfs[False], f), getattr(again, f)),
              f"two IVF builds from the same codes and seed differ in {f}")
    check(np.array_equal(ivfs[False].list_occupancy, again.list_occupancy),
          "two IVF builds differ in list occupancy")
    del again
    ivfs[True], build_s["packed"] = build_ivf(True)
    for f in fields:
        want = getattr(ivfs[False], f)
        if f == "lists_codes":
            want = pack_codes_nibbles(want)
        check(torch.equal(getattr(ivfs[True], f), want), f"packed IVF build differs in {f}")
    occ = ivfs[False].list_occupancy
    L_ivf = ivfs[False].lists_ids.shape[1]
    check(int(occ.sum()) == args.docs, "the IVF build dropped documents")
    log(f"[ivf] build_ivf nlist={IVF_NLIST} iters={IVF_KMEANS_ITERS} seed={IVF_SEED} on the card: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in build_s.items())
        + f"; two builds identical, packed = packed(int8); L={L_ivf}, occupancy "
        f"min {occ.min()} median {int(np.median(occ))} max {occ.max()}; lists int8 "
        f"{ivfs[False].lists_codes.numel() / 1e9:.2f} GB, packed "
        f"{ivfs[True].lists_codes.numel() / 1e9:.2f} GB; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    r = ivf.probe_rank_thresholds(occ, probe_budget=PROBE_BUDGET, nlist=IVF_NLIST)
    check(r.min() != r.max(), f"budget {PROBE_BUDGET} gives uniform thresholds: no masked run")
    variants = [("int8", False, None), ("packed", True, None),
                ("masked", False, PROBE_BUDGET), ("masked packed", True, PROBE_BUDGET)]
    ivf_served, ivf_report = {}, {}
    for tag, packed, budget in variants:
        index = ivfs[packed]
        if budget:
            def search(q, index=index, backend="auto"):
                return ivf.search_budget(index, q, probe_budget=PROBE_BUDGET, k=K,
                                         backend=backend)
        else:
            def search(q, index=index, backend="auto"):
                return ivf.search(index, q, nprobe=IVF_NPROBE, k=K, backend=backend)
        results, launches, seq_ms, pipe_ms, stats = serve_checked(
            f"ivf {tag}", encode, search, batches, cfg, [(gather_mod.sdc_gather_topk, 1)])
        for v, i in results:
            check(bool(((i >= 0) & (i < args.docs)).all()), f"ivf {tag}: ids out of range")
        pv, pi = search(report[packed]["codes"], backend="torch")
        v0, i0 = results[0]
        check(torch.equal(v0, pv) and torch.equal(i0, pi),
              f"ivf {tag}: served search differs from the plain version")
        ivf_served[tag] = results
        ivf_report[tag] = dict(launches=launches, err=float((v0 - pv).abs().max()),
                               seq_ms=seq_ms, pipe_ms=pipe_ms, idle=stats["device_idle_frac"])
        log(f"[ivf] {tag}: {len(batches)} requests of {SERVE_Q} served"
            f"{f' under probe budget {PROBE_BUDGET}' if budget else f' at nprobe {IVF_NPROBE}'}, "
            f"{launches} gather launches, bit-identical to serve_sequential and to the plain "
            "version")
    for a, b in (("int8", "packed"), ("masked", "masked packed")):
        for (v, i), (pv, pi) in zip(ivf_served[a], ivf_served[b]):
            check(torch.equal(v, pv) and torch.equal(i, pi), f"ivf {a} and {b} results differ")
    for batch, (v, i) in zip(batches, ivf_served["int8"]):
        bv, bi = ivf.search_budget(ivfs[False], encode(batch),
                                   probe_budget=IVF_NPROBE * IVF_NLIST, k=K)
        check(torch.equal(v, bv) and torch.equal(i, bi),
              "probe budget nprobe * nlist differs from flat nprobe")
    log("[ivf] packed = int8 under nprobe and under the budget; budget "
        f"{IVF_NPROBE * IVF_NLIST} = nprobe {IVF_NPROBE}, bit for bit")

    # the unfused flat search of one request against the fused one
    scores_launches = {}
    for packed, index in indexes.items():
        sdc_mod.sdc_scores.launches = 0
        uv, ui = ops_mod.sdc_search(report[packed]["codes"], index.codes, index.inv_norm,
                                    n_levels=LEVELS, k=K, packed=packed, fused=False)
        scores_launches[packed] = sdc_mod.sdc_scores.launches
        check(scores_launches[packed] == 1,
              f"the unfused search launched sdc_scores {scores_launches[packed]} times")
        v0, i0 = served[packed][0]
        check(torch.equal(uv, v0) and torch.equal(ui, i0),
              f"unfused search (packed={packed}) differs from the fused one")
    log("[ivf] ops.sdc_search(fused=False) = fused, int8 and packed, one request of "
        f"{args.docs} documents")

    # the unfused routes at the CLI's batch (it sends every query in one
    # call): 1,024 queries at k = 5000 over the flat index and the IVF
    # lists, a chunk of queries at a time sized from free memory; four of
    # the queries held against the plain versions
    q_big = torch.randint(0, 2**LEVELS, (1024, CODE_DIM), generator=gen,
                          device=device).to(torch.int8)
    rows = torch.tensor([0, 1, 1022, 1023], device=device)
    probes_big = ivf.coarse_probes(q_big, ivfs[False].centroids, ivfs[False].centroid_codes,
                                   nprobe=IVF_NPROBE, n_levels=LEVELS)
    lists = (ivfs[False].lists_codes, ivfs[False].lists_inv_norm, ivfs[False].lists_ids)
    for what, run, plain in (
        ("flat sdc_topk",
         lambda q: sdc_mod.sdc_topk(q, indexes[False].codes, indexes[False].inv_norm,
                                    n_levels=LEVELS, k=5000),
         lambda q: sdc_mod.sdc_topk_torch(q, indexes[False].codes, indexes[False].inv_norm,
                                          n_levels=LEVELS, k=5000)),
        ("IVF gather",
         lambda q: gather_mod.sdc_gather_topk(q, *lists, probes_big, n_levels=LEVELS, k=5000),
         lambda q: gather_mod.sdc_gather_topk_torch(q, *lists, probes_big[rows],
                                                    n_levels=LEVELS, k=5000)),
    ):
        sdc_mod.sdc_scores.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bv, bi = run(q_big)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        chunks = sdc_mod.sdc_scores.launches
        check(bv.shape == (1024, 5000) and bool(torch.isfinite(bv).all()),
              f"{what} at Q = 1024, k = 5000: bad scores")
        pv, pi = plain(q_big[rows])
        check(torch.equal(bv[rows], pv) and torch.equal(bi[rows], pi),
              f"{what} at Q = 1024, k = 5000 differs from the plain version")
        log(f"[unfused] {what} Q=1024 k=5000 over {args.docs} documents: {chunks} query chunks "
            f"(sdc_scores launches), {1e3 * dt:.1f} ms on {name} ({smi}), peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; queries 0, 1, 1022, 1023 "
            "equal to the plain version")
    del q_big, probes_big, bv, bi
    idx_ivf = torch.cat([i for _, i in ivf_served["int8"]], 0)
    log(f"[ivf] recall@{K} against the positive doc (untrained weights, information only): "
        f"flat BEBR={recall_at_k(idx_b, gt.cpu()):.4f} IVF nprobe {IVF_NPROBE}="
        f"{recall_at_k(idx_ivf, gt.cpu()):.4f}")

    # -- 4. times ----------------------------------------------------------
    kernels = []
    for packed, index in indexes.items():
        tag = "packed" if packed else "int8"
        rep = report[packed]
        q = rep["codes"]
        args_k = dict(n_levels=LEVELS, k=K, packed=packed)
        ms = cuda_ms(lambda: sdc_mod.sdc_topk(q, index.codes, index.inv_norm, **args_k), 20)
        plain_ms = cuda_ms(
            lambda: sdc_mod.sdc_topk_torch(q, index.codes, index.inv_norm, **args_k), 3)
        n = index.codes.shape[0]
        nbytes = n * (index.codes.shape[1] + 4) + q.numel() + q.shape[0] * K * 8
        ops = 2 * q.shape[0] * n * CODE_DIM
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
        library_ms = None
        if not packed:
            # yardstick only: cuBLASLt int8 product + epilogue + topk; _int_mm
            # needs N % 8 == 0, so it runs on the first N - N % 8 documents
            n8 = n - n % 8
            d8, inv8 = index.codes[:n8], index.inv_norm[:n8]
            sq = q.to(torch.int32).sum(-1, keepdim=True)
            sd = d8.to(torch.int32).sum(-1)[None, :]

            def library():
                from repro_torch.core.binarize_lib import sdc_affine_epilogue
                dot = torch._int_mm(q, d8.t())
                s = sdc_affine_epilogue(dot, sq + sd, dim=CODE_DIM, n_levels=LEVELS,
                                        inv_norm=inv8[None, :])
                return torch.topk(s, K)

            library_ms = cuda_ms(library, 3)
        kernels.append(dict(
            name=f"sdc_topk_{tag}", route="cuda", source=SOURCE, replaces=REPLACES[packed],
            launches=rep["launches"], max_abs_err=rep["err"], ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms,
        ))
        log(f"[time] sdc_topk {tag} Q={q.shape[0]} N={n} D={CODE_DIM} k={K} on {name} "
            f"({smi}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, HBM bound {bytes_ms:.3f} ms, "
            f"int8 op bound {ops_ms:.4f} ms, library "
            f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'}")
        log(f"[time] serving {tag}: sequential {rep['seq_ms']:.3f} ms/batch, pipelined "
            f"{rep['pipe_ms']:.3f} ms/batch (scan stage idle {100 * rep['idle']:.0f}%), "
            f"{SERVE_REQUESTS} requests of {SERVE_Q} on {name} ({smi})")

    # -- 7. the new kernels at the main path's shapes ------------------------
    q = report[False]["codes"]
    for tag, packed, budget in (("int8", False, None), ("packed", True, None),
                                ("masked", False, PROBE_BUDGET)):
        index = ivfs[packed]
        if budget:
            r = ivf.probe_rank_thresholds(index.list_occupancy, probe_budget=budget,
                                          nlist=index.nlist)
            probes = ivf.coarse_probes(q, index.centroids, index.centroid_codes,
                                       nprobe=int(r.max()), n_levels=LEVELS)
            cols = torch.arange(probes.shape[1], device=device)
            live = cols[None, :] < torch.as_tensor(r, device=device)[probes.long()]
            mask = live[:, :, None].float().expand(-1, -1, L_ivf)
        else:
            probes = ivf.coarse_probes(q, index.centroids, index.centroid_codes,
                                       nprobe=IVF_NPROBE, n_levels=LEVELS)
            live = torch.ones(probes.shape, dtype=torch.bool, device=device)
            mask = None
        gargs = (q, index.lists_codes, index.lists_inv_norm, index.lists_ids, probes)
        gkw = dict(n_levels=LEVELS, k=K, packed=packed, cand_mask=mask)
        ms = cuda_ms(lambda: gather_mod.sdc_gather_topk(*gargs, **gkw), 10)
        plain_ms = cuda_ms(lambda: gather_mod.sdc_gather_topk_torch(*gargs, **gkw), 1)
        occ_t = torch.as_tensor(index.list_occupancy, device=device).long()
        probed = probes.long()[live]
        rows = int(occ_t[torch.unique(probed)].sum())  # distinct probed lists, read once
        rows_pairs = int(occ_t[probed].sum())  # every (query, probe) pair's list
        row_bytes = index.lists_codes.shape[-1] + 8
        nbytes = rows * row_bytes + q.numel() + probes.numel() * 4 + q.shape[0] * K * 8
        ops = 2 * rows_pairs * CODE_DIM
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
        rep = ivf_report[tag]
        kernels.append(dict(
            name=f"sdc_gather_topk_{tag}", route="cuda", source=GATHER_SOURCE,
            replaces=GATHER_REPLACES, launches=rep["launches"], max_abs_err=rep["err"], ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None,
        ))
        log(f"[time] sdc_gather_topk {tag} Q={q.shape[0]} nprobe={probes.shape[1]} "
            f"({int(live.sum())} live pairs) L={L_ivf} D={CODE_DIM} k={K} on {name} ({smi}): "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.3f} ms "
            f"(HBM {bytes_ms:.3f} ms for {nbytes / 1e9:.3f} GB: "
            f"{int(torch.unique(probed).numel())} distinct lists, {rows} rows, read once; "
            f"int8 ops {ops_ms:.4f} ms); no-reuse bytes {rows_pairs * row_bytes / 1e9:.3f} GB "
            f"({1e3 * rows_pairs * row_bytes / HBM_BYTES_PER_S:.3f} ms), padded-L bytes "
            f"{int(torch.unique(probed).numel()) * L_ivf * row_bytes / 1e9:.3f} GB; library none; "
            f"kernel share of a sequential request {ms / rep['seq_ms']:.2f}")
        log(f"[time] IVF serving {tag}: sequential {rep['seq_ms']:.3f} ms/batch, pipelined "
            f"{rep['pipe_ms']:.3f} ms/batch (scan stage idle {100 * rep['idle']:.0f}%), "
            f"{SERVE_REQUESTS} requests of {SERVE_Q} on {name} ({smi})")
    log(f"[time] build_ivf (k-means + bucketing) N={args.docs} nlist={IVF_NLIST} "
        f"iters={IVF_KMEANS_ITERS}: " + ", ".join(f"{k} {v:.3f} s" for k, v in build_s.items())
        + f" on {name} ({smi})")

    for packed, index in indexes.items():
        tag = "packed" if packed else "int8"
        sargs = (q, index.codes, index.inv_norm)
        skw = dict(n_levels=LEVELS, packed=packed)
        n = index.codes.shape[0]
        # the whole [Q, N] matrix at the main path's shapes, exactly
        s, ps = sdc_mod.sdc_scores(*sargs, **skw), sdc_mod.sdc_scores_torch(*sargs, **skw)
        check(s.shape == (q.shape[0], n) and torch.equal(s, ps),
              f"sdc_scores {tag} Q={q.shape[0]} N={n}: kernel != plain")
        err = float((s - ps).abs().max())
        del s, ps
        log(f"[scores] {tag}: the full [{q.shape[0]}, {n}] score matrix exactly equal to the "
            "plain version")
        ms = cuda_ms(lambda: sdc_mod.sdc_scores(*sargs, **skw), 5)
        plain_ms = cuda_ms(lambda: sdc_mod.sdc_scores_torch(*sargs, **skw), 1)
        nbytes = n * (index.codes.shape[1] + 4) + q.numel() + q.shape[0] * n * 4
        ops = 2 * q.shape[0] * n * CODE_DIM
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
        library_ms = None
        if not packed:
            # yardstick only: cuBLASLt int8 product + epilogue on N - N % 8 documents
            n8 = n - n % 8
            d8, inv8 = index.codes[:n8], index.inv_norm[:n8]
            sq = q.to(torch.int32).sum(-1, keepdim=True)
            sd = d8.to(torch.int32).sum(-1)[None, :]

            def library():
                from repro_torch.core.binarize_lib import sdc_affine_epilogue
                return sdc_affine_epilogue(torch._int_mm(q, d8.t()), sq + sd, dim=CODE_DIM,
                                           n_levels=LEVELS, inv_norm=inv8[None, :])

            library_ms = cuda_ms(library, 3)
        kernels.append(dict(
            name=f"sdc_scores_{tag}", route="cuda", source=SCORES_SOURCE,
            replaces=SCORES_REPLACES[packed], launches=scores_launches[packed],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=library_ms,
        ))
        log(f"[time] sdc_scores {tag} Q={q.shape[0]} N={n} D={CODE_DIM} on {name} ({smi}): "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, HBM bound {bytes_ms:.3f} ms "
            f"({nbytes / 1e9:.2f} GB, the [Q, N] f32 output included), int8 op bound "
            f"{ops_ms:.4f} ms, library "
            f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'}")

    # -- 8. the bitwise baseline over the same codes -------------------------
    sdc_ms = next(k["ms"] for k in kernels if k["name"] == "sdc_scores_int8")
    del ivfs
    kernels.append(bitwise_phase(d_codes, encode, batches, cfg, device, name, smi, sm_clock_mhz,
                                 sdc_ms))

    # -- 8b. bi-granular retrieval over the same codes -------------------------
    full_scan_ms = next(k["ms"] for k in kernels if k["name"] == "sdc_topk_packed")
    kernels += bigranular_phase(d_codes, encode, batches, cfg, device, name, smi, full_scan_ms)
    torch.cuda.empty_cache()

    # -- 8c. HNSW graph search at the CLI's width ------------------------------
    kernels.append(hnsw_phase(model, encode, cfg, args.seed, device, name, smi))

    # -- 9. the dlrm-rm2 serving forward at full width ------------------------
    del indexes, d_codes
    torch.cuda.empty_cache()
    kernels.append(dlrm_phase(args.seed, device, name, smi))
    log(f"[smoke] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    log("kernels: " + ", ".join(f"{k['name']} matched, launches={k['launches']}"
                                for k in kernels))
    log(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
