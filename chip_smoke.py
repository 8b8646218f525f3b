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
     yardstick at the main path's shapes, and the serving drivers.

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
SERVE_Q, SERVE_REQUESTS, K = 64, 8, 10
DIM, CODE_DIM, LEVELS = 256, 128, 4
SOURCE = "src/repro_torch/kernels/sdc/csrc/sdc_topk.cu"
DEVICE = "cuda:0"
REPLACES = {False: "src/repro/kernels/sdc/sdc.py:318", True: "src/repro/kernels/sdc/sdc.py:303"}


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
            m = re.search(r"Compiling entry function '.*?(sdc_(?:scan|merge)_kernel)(?:ILi(\d+)ELb([01]))?", line)
            if m:
                kernel = m.group(1) + (f" D={m.group(2)}{' packed' if m.group(3) == '1' else ''}"
                                       if m.group(2) else "")
            elif "registers" in line or "spill" in line:
                log(f"[build]   {kernel}: {line.replace('ptxas info    :', '').strip()}")

    # -- 1. device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. kernel vs plain, edge cases -----------------------------------
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    n_cases = edge_cases(device, gen)
    log(f"[edge] {n_cases} cases exactly equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s)")

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
    log("kernels: " + ", ".join(f"{k['name']} matched, launches={k['launches']}"
                                for k in kernels))
    log(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
