#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--docs 10000037]

Run from the root of a checkout. It builds the CUDA kernels from the
sources in the checkout, then, in order, and failing on the first phase
that fails:

  1. prints the card, the device count and the card's power limit;
  2. holds every kernel against its plain PyTorch version on the card
     (exactly equal scores and ids) in the edge cases: n_levels 1, 2, 4
     in int8 and nibble-packed form, k > N, k = 1024, an all-excluded
     tail, duplicated documents (ties), Q not a multiple of any tile;
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
     and nprobe = nlist against sdc_topk over the same documents;
  6. drives the IVF serving path over phase 3's codes: build_ivf on the
     card (nlist 64, 20 k-means iterations, seed 1), twice, checked
     identical, int8 and packed; 8 requests of 64 queries at nprobe 32
     and under the probe budget 2,080 (the masked kernel), each checked
     against serve_sequential, the plain version and the other form, with
     launch counts zeroed just before and read just after every run; the
     budget 32 * 64 against nprobe 32; the unfused flat search
     (ops.sdc_search(fused=False)) of one request against the fused one;
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
  9. drives the dlrm-rm2 serving forward at full width (26 tables of
     1,048,576 x 64 float32, 6.98 GB, seeded): dlrm_serve_step on 3
     batches each at B = 512 and B = 262,144, with the dot_interact
     launch count zeroed just before and read just after; holds the
     kernel against its plain version on every batch, exactly, and the
     logits against forwards with the plain interaction (exactly) and with
     the Gram-matrix formulation (within float32 rounding); times the
     kernel, its plain version, its bound and the torch.bmm yardstick.

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


def edge_cases(device, gen) -> int:
    """Kernel vs plain version, exactly, in the edge cases. Returns the case count."""
    import torch

    from repro_torch.core.binarize_lib import pack_codes_nibbles
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ref import doc_inv_norms

    def case(Q, N, D, nl, k, packed, dup=False, tail=0):
        q = torch.randint(0, 2**nl, (Q, D), generator=gen, device=device).to(torch.int8)
        d = torch.randint(0, 2**nl, (N, D), generator=gen, device=device).to(torch.int8)
        if dup:
            d[N // 2:] = d[: N - N // 2].clone()
        inv = doc_inv_norms(d, nl)
        if tail:
            inv[-tail:] = 0
        dd = pack_codes_nibbles(d) if packed else d
        v, i = sdc_mod.sdc_topk(q, dd, inv, n_levels=nl, k=k, packed=packed)
        pv, pi = sdc_mod.sdc_topk_torch(q, dd, inv, n_levels=nl, k=k, packed=packed)
        what = f"Q={Q} N={N} D={D} n_levels={nl} k={k} packed={packed} dup={dup} tail={tail}"
        check(torch.equal(v, pv) and torch.equal(i, pi), f"kernel != plain: {what}")
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
    for c in cases:
        case(*c)
    case(64, 200_003, 128, 4, K, False, tail=5000)  # all-excluded tail
    case(7, 300, 128, 4, K, True, tail=300)  # everything excluded
    case(64, 200_003, 256, 4, K, True, dup=True)  # ties
    case(64, 200_003, 128, 1, K, False, dup=True)
    return len(cases) + 4


def gather_edge_cases(device, gen) -> int:
    """Gather kernel vs plain version, exactly, in its edge cases. Returns the case count."""
    import torch

    from repro_torch.core.binarize_lib import pack_codes_nibbles
    from repro_torch.kernels.sdc import gather as gather_mod
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ref import doc_inv_norms

    def case(Q, nlist, L, D, nl, k, nprobe, packed, mask=None, ties=False, full=False):
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
        v, i = gather_mod.sdc_gather_topk(q, lc, inv, ids, probes, n_levels=nl, k=k,
                                          packed=packed, cand_mask=cand)
        pv, pi = gather_mod.sdc_gather_topk_torch(q, lc, inv, ids, probes, n_levels=nl, k=k,
                                                  packed=packed, cand_mask=cand)
        what = (f"Q={Q} nlist={nlist} L={L} D={D} n_levels={nl} k={k} nprobe={nprobe} "
                f"packed={packed} mask={mask} ties={ties}")
        check(torch.equal(v, pv) and torch.equal(i, pi), f"gather kernel != plain: {what}")
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
    for Q, N, D, nl, packed in cases:
        q = torch.randint(0, 2**nl, (Q, D), generator=gen, device=device).to(torch.int8)
        d = torch.randint(0, 2**nl, (N, D), generator=gen, device=device).to(torch.int8)
        inv = doc_inv_norms(d, nl)
        inv[::7] = 0  # excluded documents
        dd = pack_codes_nibbles(d) if packed else d
        s = sdc_mod.sdc_scores(q, dd, inv, n_levels=nl, packed=packed)
        ps = sdc_mod.sdc_scores_torch(q, dd, inv, n_levels=nl, packed=packed)
        what = f"Q={Q} N={N} D={D} n_levels={nl} packed={packed}"
        check(torch.equal(s, ps), f"sdc_scores kernel != plain: {what}")
        check(bool((s[:, ::7] == -1e30).all()), f"sdc_scores: excluded docs not -1e30: {what}")
        log(f"[scores-edge] ok {what}")
    return len(cases)


def serve_checked(tag, encode, search, batches, counter, cfg):
    """Serve ``batches`` sequentially, then pipelined, each run with the
    kernel's launch count zeroed just before and read just after; checks
    that both runs launched once per request and agree. Returns (results,
    launches, sequential ms/request, pipelined ms/request, stats)."""
    import torch

    from repro_torch.launch import serving
    from repro_torch.launch.serve import serve_pipelined

    serving.warmup(encode, search, batches)
    counter.launches = 0
    t0 = time.perf_counter()
    seq = serving.serve_sequential(encode, search, batches)
    dt_seq = time.perf_counter() - t0
    check(counter.launches == len(batches),
          f"{tag}: sequential run launched the kernel {counter.launches} times")
    counter.launches = 0
    t0 = time.perf_counter()
    results, stats, _ = serve_pipelined(encode, search, batches, cfg)
    dt_pipe = time.perf_counter() - t0
    launches = counter.launches
    check(launches == len(batches),
          f"{tag}: the served requests launched the kernel {launches} times, want {len(batches)}")
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
        "bitwise", encode, search, batches, bd_mod.binary_dot, cfg)
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
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, HBM bound {bytes_ms:.4f} ms "
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
                          r"(?:ILi(\d+)ELb([01])E(?:Lb([01])E)?)?", line)
            b = re.search(r"Compiling entry function '.*?(binary_dot_kernel)ILi(\d+)ELi(\d+)E"
                          r"|Compiling entry function '.*?(dot_interact_kernel)", line)
            if m:
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
    log(f"[edge] {n_cases} cases exactly equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_gather = gather_edge_cases(device, gen)
    n_scores = scores_edge_cases(device, gen)
    log(f"[gather-edge] {n_gather} gather and {n_scores} sdc_scores cases exactly equal to "
        f"the plain versions ({time.perf_counter() - t0:.1f} s)")

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
            f"ivf {tag}", encode, search, batches, gather_mod.sdc_gather_topk, cfg)
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
