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
     of ten million documents made on the card: encode (the captured
     encode, one CUDA graph a batch shape; its first batch and ragged tail
     held against the eager twin, bit for bit), build FlatSDC int8 and packed, serve 8 requests of 64 queries through
     ServingPipeline and check them against serve_sequential, against
     each other, against the plain version, and that every search went
     through the kernel (launch counts are zeroed just before and read
     just after each run); the serving drivers with the captured encode and
     with its eager twin, in turns (the "[time] encode repair" lines, also
     for IVF, HNSW and the flat engine);
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
     codes' bit planes, a popcount term per plane pair on the tensor
     cores' binary path in the binary_dot kernel) serves the 8 requests
     of 64 queries, checked against serve_sequential and the plain
     search, with launch counts zeroed just before and read just after;
     splits a request into the kernel, the sort and the encode; holds
     the whole [64, N] binary_dot matrix against its plain version,
     exactly; times the kernel at n_levels 1, 2 and 4 (planes of
     coarse_codes) beside sdc_scores, its plain version, its bound (bytes,
     or the same scores as one int8 product; the first design's popcount
     count as information) and the torch._int_mm yardstick (the score is
     2^-2(L-1) X . Y over X = 2c - (2^L - 1)), held equal to the kernel;
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
 8d. drives the distributed engine (proxy -> leaf -> merge) with four
     leaves on the card, a (2, 2) LeafMesh, each built through
     lifecycle.EngineBuilder: the flat engine over the first 10,000,036 of
     phase 3's documents (a view), int8 and packed, 8 requests of 64
     queries through ServingPipeline with 4 sdc_topk launches and no
     sdc_scores a request, held against FlatSDC.search over the same rows
     (ties put in the merge's leaf order, engine.gather_order; equal
     without reordering wherever no tie is reordered) and against the
     plain leaves; failover with leaf 3 dead against ops.sdc_search with
     its inverse norms zeroed, and the mask flipped back; bi-granular at
     (C, k') = (2, 160) from a numpy snapshot against the flat closure's
     index, one rerank gather a request; two replicas sharing the card
     (shared leaf storage, one artifact, one tag); the HNSW engine over
     phase 8c's corpus (5,000 documents a leaf), int8 and packed, with the
     gathers and host reads of every leaf's hops counted and request 0
     held against the same engine on the CPU; times one leaf's scan beside
     its plain version, bound and yardstick, the merge, the engine's
     request beside the single scan's, the HNSW engine's request with its
     device-busy share, its hops' gathers, and the serving drivers;
 8e. drives the replicated serving tier through the CLI's routed run
     (serve.serve_routed: ServingPipeline replicas behind a QueryRouter,
     the stream through lifecycle.run_stream_with_swap) over phase 3's
     codes, 8 requests of 64 replayed 4 times: 1, 2 and 4 replicas sharing
     the card, round-robin and least-outstanding, int8 and packed, each
     bit-identical to serve_sequential with one sdc_topk launch a request;
     the captured encode against its eager twin on every batch shape, bit
     for bit; the encode's host time inside a replica pipeline and alone,
     with its launches, captured and eager, and the routed/sequential and
     routed(N)/routed(1) QPS beside the reference bench gate's 1.0 and 0.9
     (report only), with the eager encode too (int8); chaos
     r1.fail@1 with the canary re-probe (failed over, revived, nothing
     lost; the failed call launches no kernel); r1.stick@1 on two unshared
     replicas under the watchdog and a deadline; a rolling swap mid-stream
     from a snapshot of the same codes (drain, build, warm and probe
     times); the autoscaler between 1 and 3 replicas under the stream's
     own load (nothing lost, bit-identical, replicas within bounds); two
     replicas over phase 8c's HNSW closure, the gather reached through the
     router. The kernels JSON gains the routed launches' rows;
 8f. runs the autotuner (launch/autotune.py) in a temporary cache
     directory: the scan at the flat path's signature (D 128, N 10,000,037,
     k 10), int8 and packed, and at an engine leaf's 2,500,009 rows, the
     rerank at k' 160, each swept at the serving batch; every candidate's
     scores and ids against the default plan's on the sweep's operands and
     on 64 real queries, the persisted tuned_ms <= default_ms, the second
     call a cache hit; 8 requests through FlatSDC (int8, packed) and the
     flat engine with the tuned plan bit-identical to the default plan's,
     each launching the plan's grid (sdc_topk.last_geometry); times each
     candidate, the sweep and the tuned request beside the default's;
  9. drives the dlrm-rm2 serving forward at full width (26 tables of
     1,048,576 x 64 float32, 6.98 GB, seeded): dlrm_serve_step on 3
     batches each at B = 512 and B = 262,144, with the dot_interact
     launch count zeroed just before and read just after; holds the
     kernel against its plain version on every batch, exactly, and the
     logits against forwards with the plain interaction (exactly) and with
     the Gram-matrix formulation (within float32 rounding); times the
     kernel (and its device time by torch.profiler), its plain version,
     its bound and the torch.bmm yardstick;
 10. trains the binarizer at the reference CLI's width (the CLI's
     20,000-document numpy corpus, dim 256, code_dim 128, n_levels 4,
     hidden 512, queue 4,096 mining the top 64, batch 256, 300 steps,
     through serve.train_binarizer and its digest cache): (a) twice from
     one seed, bit-identical, then a bit-identical cache hit; (b) one
     train_step on the card against the port's CPU step from the same
     state and batch (loss, gradient norm, Adam's moments, parameters,
     statistics within STEP_TOL, the queue exactly; rows whose codes take
     the other sign on the two devices are set aside and counted); (c)
     FlatSDC over the trained codes, recall@10 over 2,048 queries trained,
     untrained and float, the trained weights differing from the initial
     ones and their recall within RECALL_MARGIN of the reference's, above
     or below (reference_figures/cli_recall.py), and the reference tests' claims
     (test_system, test_compat with COMPAT_RECALL_FLOOR) at their widths
     on the card; (d) the CLI's --upgrade-after through serve_routed, two
     replicas on the card: BC training 300 steps, compat encoders both
     ways, a rolling swap to v2's snapshot under mixed-version traffic
     with the sdc_topk count zeroed just before and read just after
     (nothing lost, every answer one of its version's, compat dispatches,
     both replicas on v2), the BC weights differing from v1's and the BC
     queries' recall on the v1 index within RECALL_MARGIN of the
     reference's; (e) times train_step and bc_train_step (ms a step,
     launches, device-busy share) and the 300-step walls;
 11. trains the recsys zoo at full width through the port's launcher
     (python -m repro_torch.launch.train --full, in-process): dlrm-rm2
     (26 tables of 1,048,576 x 64, 6.98 GB), two-tower-retrieval (two
     2,097,152 x 256 tables), mind and dien, each 20 steps of the CLI's
     batch of 16 in one unbroken run, then a run with a checkpoint every
     10 (train/checkpoint.py, the reference's layout) under
     build/chip_smoke_train_* (removed at the end) that ends after step
     10, resumed from that checkpoint to step 20: its losses and every
     parameter bit-identical to the unbroken run's; dot_interact launched
     once a dlrm-rm2 step (the count zeroed just before and read just
     after), its output inside a training step exactly equal to its plain
     version; a step's time (host clock, synced), launch calls, device
     kernels, device-busy share and peak memory per arch; one serving
     batch through each serve step, and tt_retrieval_bebr_step through
     sdc_topk over a million codes, the kernel's output exactly its plain
     version's on the same card tensors; dot_interact at the training
     shape with its backward timed; one SMOKE train step per arch on the
     card against the CPU's (the loss within 1e-5, Adam's moments within
     1e-4 of each leaf's largest entry); then
     examples/{train_two_tower_e2e,quickstart,compat_upgrade}_torch.py at
     their defaults: every sdc_topk call they make (FlatSDC at [32,
     20,000] k 100, [128, 20,000] k 10, the replicas' [64, 10,000] k 10)
     recorded and held exactly against its plain version, every model
     they train moved from its initial weights with its loss down (a
     binarizer's on held-out pairs against its initial weights', the
     two-tower's from its first ten steps to its last ten), each quality
     figure within 0.05
     of the range the reference's examples give over six initial-weight
     keys (reference_figures/zoo_examples.py); sdc_topk timed at the
     two-tower example's [32, 20,000], k = 100.

 12. the LM and GNN families (no kernel: the reference's models reach
     no Pallas kernel): llama3.2-1b at its full config (1.24B parameters,
     bf16) through the launcher (--full, batch 16 x 128 tokens, 4 steps,
     every leaf moved; 2 steps and a checkpoint, resumed to step 4
     bit-identical), one repeated batch through lm_train_step (its loss
     falls over 10 steps), lm_prefill_step against forward's last position
     at 2,048 tokens (the chunked attention), a prefill of 32,768 tokens
     (prefill_32k, batch cut from 32 to 1), decode token by token against
     forward, decode at a 32,768-token cache (decode_32k, batch cut from
     128 to 16) with a bf16 and an int8 cache, the int8 logits within
     0.05 of the bf16 ones; llama4-scout at full width cut to 2 layers
     (prefill of 4,096 tokens in 2,048-token routing groups against
     forward, a few decode steps); the five full LM configs on the meta
     device (elements == param_count); one SMOKE card step of each LM and
     of meshgraphnet against the CPU's; meshgraphnet --full through the
     launcher, then gnn_train_step and gnn_infer_step at the reference's
     minibatch_lg size (169,984 nodes, 168,960 edges) twice from one
     seed, bit-identical; times (tokens/s), device-busy shares and peak
     memory printed, not gated.
 13. the port's tooling (no kernel): compress_with_feedback over
     llama3.2-1b's 1.24B float32 gradients, three rounds held bit for bit
     against the CPU, and compressed_psum over a one-rank NCCL group equal
     to the dequantized tree; meanwhile, in worker processes, the dry run
     of all 40 cells on both production meshes (the meta device; every
     record ok, parameter elements against meta["params"]); five cells at
     their production shapes on one leaf of the card (two-tower
     retrieval_cand, MIND and DIEN serve_p99, dlrm-rm2 serve_bulk through
     dot_interact, meshgraphnet minibatch_lg train), their arguments'
     bytes equal to the dry run's and their FLOPs to the meta count;
     llama3.2-1b's parameters laid out over a (4, 2) mesh of the card,
     each leaf's bytes equal to the dry run's, and gathered back bit for
     bit. The dry run's records now carry each cell's per-device FLOPs,
     bytes and collectives from its sharded step (DTensor over a fake
     process group), every one ok;
 14. the hillclimb (launch/hillclimb.py): (a) the card's rates beside the
     H100 roofline constants of kernels/sdc/defaults.py, a 4 GiB
     device-to-device copy (HBM bytes/s), an 8192^3 bf16 torch.matmul and
     an 8192^3 torch._int_mm; (b) tt_retrieval's five variants at their
     production shapes on the card (the full two-tower, 1,000,000
     candidates, code_dim 64, k 100), bebr_sdc_merge's collectives over a
     one-rank NCCL group, each timed by CUDA events beside its one-device
     roofline terms; bebr_sdc, bebr_sdc_fullmesh and bebr_sdc_merge give
     identical scores and ids with inverse norms of 0 and below planted,
     and every sdc_topk call is held exactly against its plain version;
     (c) meanwhile, in worker processes, hillclimb's 26 variants dry on
     16x16 and on 2x16x16 (the meta device, a fake process group), every
     record ok; these 52 and phase 13's 80 dry-run records, 132 in all,
     each held against the JAX reference's full-depth GSPMD record of the
     same cell on the same mesh, committed in HC_RECORDS (no JAX here):
     nothing replicated, no strided layout redistributed, wire at most the
     reference's, the peak at most twice its, FLOPs a device equal for the
     12 llama3-405b train variants and decode on 16x16 and at most the
     reference's for every other record, or for the MoE cells at most
     HC_MOE_TARGETS (the whole step's share over 256 or 512, 1.2x it where
     llama4-scout's 40 query heads split 3 or 2 a model shard, or the
     reference's), each printed beside the reference (and the share);
     then faults A-D's figures (HC_FAULTS: the LM loss's gathered classes,
     microbatch16 replicated on 2x16x16, two tt_retrieval peaks) beside
     theirs before the repair;
     (d) the BEBR scan's library yardstick,
     torch._int_mm + the epilogue + torch.topk, with the query padded to
     17 rows.

Its last two lines are a JSON object of the kernels' numbers and
``{"ok": true, "device": {...}}``. Phases 3-9 use seeded, untrained
weights (their recall is information only); phase 10 trains them.
"""

from __future__ import annotations

import argparse
import json
import math
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
# the SM count and the maximum SM clock that nvidia-smi reports. Only for
# the popcount count of binary_dot's first design, printed as information.
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
# the engine: four leaves on the card; the flat list a merged result is held
# against has WIDE_MARGIN slots past k (every tie at the k-th score must fall
# inside), the coarse list of the bi-granular check RERANK_MARGIN past k'
ENGINE_LEAVES = 4
ENGINE_RERANK = (2, 160)
WIDE_MARGIN = 118
RERANK_MARGIN = 4096 - 160
# the routed tier: the 8 requests replayed ROUTED_ROUNDS times (the CLI's
# --rounds default), at each replica count and routing policy; the chaos,
# deadline and autoscaler streams are longer so the probe loop and the
# autoscaler act inside them; the reference bench gate's serving ratios
# (scripts/check_bench_gate.py:848,851), printed beside the measured ones
ROUTED_ROUNDS, ROUTED_REPLICAS = 4, (1, 2, 4)
ROUTED_POLICIES = ("round-robin", "least-outstanding")
CHAOS_ROUNDS, AUTOSCALE_ROUNDS, SWAP_AFTER = 8, 16, 12
PROBE_EVERY_S, WATCHDOG_BUDGET_S, DEADLINE_S = 0.02, 0.1, 2.0
GATE_SERVING_RATIO, GATE_REPLICA_RATIO = 1.0, 0.9
# binarizer training (phase 10) at the reference CLI's width: its corpus
# (clustered_corpus(seed, 20000, ., 256)), --steps and batch; recall over
# TRAIN_QUERIES queries of that corpus (its documents do not depend on the
# query count; the CLI's 64 give recall a standard deviation near 0.055);
# the card's step held against the CPU's after STEP_WARM steps, within
# STEP_TOL; TIME_STEPS timed steps
TRAIN_DOCS, TRAIN_QUERIES, TRAIN_STEPS, TRAIN_BATCH = 20_000, 2048, 300, 256
STEP_WARM, STEP_TOL, TIME_STEPS = 3, 1e-5, 20
# the JAX reference's recall@10 at seed 0 over those 2048 queries, on the
# CPU (PYTHONPATH=src JAX_PLATFORMS=cpu python reference_figures/cli_recall.py):
# the trained binarizer through a flat SDC index, and the BC-trained next
# version's queries on the v1 index, to which the port is held within
# RECALL_MARGIN; and the untrained binarizer (printed beside the port's:
# at this width the CLI's training lowers recall)
REF_CLI_RECALL, REF_BC_RECALL, RECALL_MARGIN = 0.7124, 0.1445, 0.05
REF_UNTRAINED_RECALL = 0.9468
# the CLI's upgrade (--replicas 2 --upgrade-after 16) over the 8 requests
# of 64 in both versions, replayed ROUTED_ROUNDS times
UPGRADE_REPLICAS, UPGRADE_AFTER = 2, 16
# the recsys zoo (phase 11): the launcher's --batch default, steps and
# checkpoint interval; timed steps; the tests' tolerances for a SMOKE card
# step against the CPU's; candidate codes of the BEBR retrieval step
ZOO_ARCHS = ("dlrm-rm2", "two-tower-retrieval", "mind", "dien")
ZOO_BATCH, ZOO_STEPS, ZOO_CKPT_EVERY, ZOO_TIME_STEPS = 16, 20, 10, 5
ZOO_LOSS_TOL, ZOO_GRAD_TOL = 1e-5, 1e-4
ZOO_BEBR_DOCS = 1_000_000
# the LM and GNN families (phase 12): llama3.2-1b at full width through the
# launcher (--batch ZOO_BATCH rows of 128 tokens), LM_STEPS steps unbroken and
# through one checkpoint at LM_RESUME_AT; LM_FIT_STEPS steps on one repeated
# batch; prefill against forward at LM_CHUNKED_S (the chunked attention:
# > attn_chunk 1,024, a multiple); prefill_32k's and decode_32k's length
# LM_LONG with their batches cut from 32 and 128 to LM_PREFILL_BATCH and
# LM_DECODE_BATCH (one chunk's float32 logits are 4.3 GB at batch 1, a
# bfloat16 cache 17 GB at batch 16); decode against forward over a prompt
# of LM_PROMPT tokens within LM_DECODE_TOL of each row's largest |logit| and
# the int8 cache within LM_INT8_TOL of the bfloat16 one (the reference's
# bound, tests/test_models_lm.py); prefill against forward's last position
# within one bfloat16 rounding of the largest (LM_PREFILL_TOL); llama4-scout
# cut to MOE_LAYERS layers (48 do not fit one card), a prefill of
# MOE_PREFILL_S tokens (two 2,048-token routing groups); meshgraphnet at the
# reference's minibatch_lg size (configs/cells.py:143)
LM_ARCH, MOE_ARCH, GNN_ARCH = "llama3.2-1b", "llama4-scout-17b-a16e", "meshgraphnet"
LM_IDS = ("llama3-405b", "llama3.2-1b", "mistral-large-123b", "llama4-scout-17b-a16e",
          "grok-1-314b")
LM_STEPS, LM_RESUME_AT, LM_FIT_STEPS, LM_TIME_STEPS = 4, 2, 10, 3
LM_CHUNKED_S, LM_LONG, LM_PREFILL_BATCH, LM_DECODE_BATCH, LM_DECODE_STEPS = 2048, 32768, 1, 16, 8
LM_PROMPT, LM_PROMPT_BATCH = 16, 2
LM_DECODE_TOL, LM_INT8_TOL, LM_PREFILL_TOL = 0.05, 0.05, 2.0 ** -7
MOE_LAYERS, MOE_PREFILL_S, MOE_DECODE_BATCH, MOE_DECODE_STEPS = 2, 4096, 4, 4
GNN_LG_NODES, GNN_LG_EDGES, GNN_LG_FEAT, GNN_STEPS, GNN_TIME_STEPS = 169_984, 168_960, 100, 4, 3
# the JAX reference examples' quality figures on the CPU, (key 0, min, max)
# over REF_ZOO_KEYS initial-weight keys (PYTHONPATH=src JAX_PLATFORMS=cpu
# python reference_figures/zoo_examples.py): the port's figure on the card
# is held within FIGURE_MARGIN of that range, above or below
REF_ZOO_KEYS = 6
REF_ZOO_FIGURES = {
    "tt_group_float": (1.0, 1.0, 1.0),
    "tt_group_bebr": (1.0, 1.0, 1.0),
    "tt_cover": (0.82, 0.8, 0.84),
    "qs_recall_float": (1.0, 1.0, 1.0),
    "qs_recall_bebr": (0.953, 0.938, 0.977),
    "bc_old_old": (0.828, 0.809, 0.891),
    "bc_naive": (0.305, 0.262, 0.391),
    "bc_compat": (0.594, 0.477, 0.617),
    "bc_mixed_v1": (0.791, 0.791, 0.891),
    "bc_mixed_v2": (0.647, 0.516, 0.647),
}
FIGURE_MARGIN = 0.05
# the autotuner (phase 8f): the rerank's survivors (the bi-granular k') and
# the timed calls a candidate
TUNE_RERANK_KC, TUNE_REPS = 160, 5
# the port's tooling (phase 13): gradient compression over COMP_ROUNDS rounds
# at LM_ARCH's full size, the host check of every leaf while its first round
# stays under COMP_HOST_S_A_ROUND (else the embedding and the stacked leaves
# under COMP_SMALL elements); the dry run of all 40 cells on both production
# meshes and, queued behind it, hillclimb's 26 variants on both (phase 14's),
# on one pool of DRYRUN_WORKERS processes started with phase 13, so the
# variants run while the card works through phases 13 and 14; CARD_CELLS at their production shapes
# on one leaf of the card, CELL_TIME_STEPS timed steps each; the sharded
# state's mesh
COMP_ROUNDS, COMP_HOST_S_A_ROUND, COMP_SMALL = 3, 10.0, 1 << 26
DRYRUN_WORKERS = 7
CARD_CELLS = (("two-tower-retrieval", "retrieval_cand"), ("mind", "serve_p99"),
              ("dien", "serve_p99"), ("dlrm-rm2", "serve_bulk"), ("meshgraphnet", "minibatch_lg"))
CELL_TIME_STEPS = 5
SHARD_MESH = ((4, 2), ("data", "model"))
# the hillclimb (phase 14): the card's rates from a RATE_COPY_BYTES copy and
# RATE_MM_N^3 products;
# tt_retrieval's variants at HC_CANDIDATES candidates, HC_TIME_REPS timed
# calls each, the inverse norms of HC_PLANTED set to 0 and below (-50 flips a
# negative affine score far above the rest, so planted rows reach the top k)
RATE_COPY_BYTES, RATE_MM_N, RATE_REPS = 4 << 30, 8192, 10
HC_CANDIDATES, HC_CODE_DIM, HC_LEVELS, HC_K = 1_000_000, 64, 4, 100
HC_TIME_REPS = 5
# the reference's full-depth records phase 14 holds every record to: on 16x16
# the 20 LM cells and the LM variants (34), the 20 other dry-run cells and
# the gnn_ogb and tt_retrieval variants (32); on 2x16x16 all 66
HC_RECORDS = {"tests/_torch_hillclimb_ref_lm.json": 34,
              "tests/_torch_hillclimb_ref_cells.json": 32,
              "tests/_torch_hillclimb_ref_2x16x16.json": 66}
# the MoE dry-run cells' FLOPs a device at most, on either mesh (a multiple
# of the whole step's share, flops_per_step / 256 or 512; a multiple of the
# reference's), None where not bounded; llama4-scout's 1.2 is 40 query heads
# over 16 model shards, 3 a shard at most against a share of 2.5
# (tests/_torch_hillclimb_ref.py)
HC_MOE_TARGETS = {
    ("llama4-scout-17b-a16e", "train_4k"): (1.2, None),
    ("llama4-scout-17b-a16e", "prefill_32k"): (1.2, None),
    ("llama4-scout-17b-a16e", "decode_32k"): (None, 1.0),
    ("llama4-scout-17b-a16e", "long_500k"): (1.2, None),
    ("grok-1-314b", "train_4k"): (None, 1.0),
    ("grok-1-314b", "prefill_32k"): (1.229, 1.0),
    ("grok-1-314b", "decode_32k"): (1.001, None),
    ("grok-1-314b", "long_500k"): (1.001, None),
}
INT_MM_MIN_ROWS = 17  # torch._int_mm on the card takes more than 16 rows
# the four faults this tree repairs, each record's figure against the
# reference's before the repair (the parent tree's count on the CPU, torch
# 2.13, full depth), printed beside this run's: (record, metric, before)
HC_FAULTS = (("A", "llama3.2-1b|train_4k|16x16", "wire", 2.20),
             ("A", "llama3.2-1b|train_4k|16x16", "peak", 6.54),
             ("A", "llama3.2-1b|train_4k|2x16x16", "wire", 1.48),
             ("A", "llama3.2-1b|train_4k|2x16x16", "peak", 6.38),
             ("B", "llama405b_train|microbatch16|2x16x16", "flops", 11.41),
             ("C", "tt_retrieval|float_index|16x16", "peak", 26.6),
             ("C", "tt_retrieval|float_index|2x16x16", "peak", 47.7),
             ("D", "tt_retrieval|bebr_sdc_fullmesh|16x16", "peak", 2.43),
             ("D", "tt_retrieval|bebr_sdc_fullmesh|2x16x16", "peak", 2.59))
HC_PLANTED = {5: 0.0, 250_001: -0.0, 500_002: -0.5, 999_999: 0.0,
              **{i: -50.0 for i in range(17, 1_000_000, 41_667)}}


def ivf_params():
    """The CLI's IVF build parameters: nlist, nprobe, seed, k-means iterations."""
    from repro_torch.launch.serve import cli_builder

    p = cli_builder("ivf").params
    return p["nlist"], p["nprobe"], p["seed"], p["kmeans_iters"]


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
    request) pairs; a list gives each request its own count; a third item
    names another counter attribute than ``launches``) that many times,
    and agree. Returns (results, the first kernel's launches in the
    pipelined run, sequential ms/request, pipelined ms/request, stats)."""
    import torch

    from repro_torch.launch import serving

    def attr(entry):
        return entry[2] if len(entry) > 2 else "launches"

    def want(n):
        return sum(n) if isinstance(n, list) else n * len(batches)

    def zero():
        for entry in counts:
            setattr(entry[0], attr(entry), 0)

    def read(run):
        for entry in counts:
            got = getattr(entry[0], attr(entry))
            check(got == want(entry[1]),
                  f"{tag}: the {run} run counted {entry[0].__name__}.{attr(entry)} = {got}, "
                  f"want {want(entry[1])}")

    serving.warmup(encode, search, batches)
    zero()
    t0 = time.perf_counter()
    seq = serving.serve_sequential(encode, search, batches)
    dt_seq = time.perf_counter() - t0
    read("sequential")
    zero()
    t0 = time.perf_counter()
    results, stats = serving.serve_batches(encode, search, batches, config=cfg)
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


def encode_repair(tag, encode, eager, search, batches, cfg, name, smi):
    """Both serving drivers with the captured encode and with its eager twin,
    in turns (captured, eager, eager, captured), each warmed first: the
    sequential and pipelined ms/batch of each, every result bit-identical
    across the two. Returns {encode: (sequential ms, pipelined ms)}."""
    import torch

    from repro_torch.launch import serving

    times = {"captured": [], "eager": []}
    want = None
    for which in ("captured", "eager", "eager", "captured"):
        enc = encode if which == "captured" else eager
        serving.warmup(enc, search, batches)
        t0 = time.perf_counter()
        seq = serving.serve_sequential(enc, search, batches)
        dt_seq = time.perf_counter() - t0
        t0 = time.perf_counter()
        results, _ = serving.serve_batches(enc, search, batches, config=cfg)
        dt_pipe = time.perf_counter() - t0
        want = want or seq
        for (v, i), (sv, si), (wv, wi) in zip(results, seq, want):
            check(torch.equal(v, sv) and torch.equal(i, si) and torch.equal(v, wv)
                  and torch.equal(i, wi), f"encode repair {tag}: {which} results differ")
        times[which].append((1e3 * dt_seq / len(batches), 1e3 * dt_pipe / len(batches)))
    out = {w: tuple(sum(x) / len(t) for x in zip(*t)) for w, t in times.items()}
    log(f"[time] encode repair {tag} on {name} ({smi}): sequential "
        f"{out['captured'][0]:.3f} ms/batch captured, {out['eager'][0]:.3f} eager; pipelined "
        f"{out['captured'][1]:.3f} captured, {out['eager'][1]:.3f} eager; pipelined/sequential "
        f"{out['captured'][1] / out['captured'][0]:.3f} captured, "
        f"{out['eager'][1] / out['eager'][0]:.3f} eager ({len(batches)} requests of "
        f"{batches[0].shape[0]}, mean of two runs each, bit-identical)")
    return out


def bitwise_phase(d_codes, encode, batches, cfg, device, name, smi, sm_clock_mhz, sdc_ms):
    """Phase 8: FlatBitwise over the corpus codes. Returns the kernel's JSON row."""
    import torch

    from repro_torch.core.binarize_lib import coarse_codes, pack_code_planes
    from repro_torch.index.flat import FlatBitwise
    from repro_torch.kernels.binary_dot import kernel as bd_mod
    from repro_torch.kernels.binary_dot.ops import binary_dot_search_torch
    from repro_torch.kernels.binary_dot.ref import binary_dot_ref
    from repro_torch.kernels.sdc.ops import select_topk

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
    n8 = N - N % 8
    row = None
    for levels in (1, 2, LEVELS):
        cq, cd = ((q_codes, d_codes) if levels == LEVELS
                  else (coarse_codes(c, LEVELS, levels) for c in (q_codes, d_codes)))
        qpl = pack_code_planes(cq, levels)
        dpl = index.packed if levels == LEVELS else pack_code_planes(cd, levels)
        ms = cuda_ms(lambda: bd_mod.binary_dot(qpl, dpl, m=CODE_DIM), 5)
        plain_ms = cuda_ms(lambda: binary_dot_ref(qpl, dpl, CODE_DIM), 1)
        words = levels * CODE_DIM // 32
        nbytes = N * words * 4 + SERVE_Q * words * 4 + SERVE_Q * N * 4
        ops = 2 * SERVE_Q * N * CODE_DIM  # the same scores as one int8 product, at any n_levels
        popc = SERVE_Q * N * levels * words  # the first design's __popc, information only
        ops_ms, bytes_ms = 1e3 * ops / INT8_OPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S
        bound_ms = max(ops_ms, bytes_ms)
        # yardstick only: with planes weighted 2^-s the score is
        # 2^-2(L-1) X . Y, X = 2c - (2^L - 1) an odd int8 in [-15, 15], so
        # one int8 product computes it exactly; _int_mm needs N % 8 == 0,
        # so on the first N - N % 8 documents
        xq = (2 * cq.to(torch.int16) - (2**levels - 1)).to(torch.int8)
        xd = (2 * cd[:n8].to(torch.int16) - (2**levels - 1)).to(torch.int8)
        unit = 2.0 ** (-2 * (levels - 1))

        def int_mm():
            return torch._int_mm(xq, xd.t()).to(torch.float32) * unit

        live = bd_mod.binary_dot(qpl, dpl, m=CODE_DIM)[:, :n8]
        check(torch.equal(int_mm(), live), f"binary_dot n_levels={levels} yardstick "
              f"(torch._int_mm) differs from the kernel on {n8} columns")
        del live
        library_ms = cuda_ms(int_mm, 5)
        del xd, dpl
        if levels == LEVELS:
            row = dict(
                name="binary_dot", route="cuda", source=BINARY_DOT_SOURCE,
                replaces=BINARY_DOT_REPLACES, launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=library_ms,
            )
        log(f"[time] binary_dot n_levels={levels} Q={SERVE_Q} N={N} m={CODE_DIM} on {name} "
            f"({smi}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms "
            f"(torch._int_mm over X = 2c - {2**levels - 1} on {n8} documents, equal to the "
            f"kernel there); bound {bound_ms:.3f} ms by "
            f"{'operations' if ops_ms >= bytes_ms else 'bytes'} (HBM {bytes_ms:.3f} ms, "
            f"{nbytes / 1e9:.2f} GB; int8 product {ops_ms:.3f} ms, {ops / 1e9:.1f} GOP); "
            f"the first design's (CUDA cores) {popc / 1e9:.2f}e9 __popc "
            f"{1e3 * popc / popc_per_s:.3f} ms at "
            f"{POPC_PER_SM_CLOCK}/SM/clock x {sms} SMs x {sm_clock_mhz:.0f} MHz (information "
            f"only); sdc_scores int8 on the same [{SERVE_Q}, {N}] {sdc_ms:.3f} ms, ratio "
            f"{ms / sdc_ms:.2f}")

    # a request's split: the kernel (timed above), the stable sort of its
    # [Q, N] scores (select_topk), the encode and the planes' packing
    scores = bd_mod.binary_dot(pack_code_planes(q_codes, LEVELS), index.packed, m=CODE_DIM)
    sort_ms = cuda_ms(lambda: select_topk(scores, K), 5)
    encode_ms = cuda_ms(lambda: pack_code_planes(encode(batches[0]), LEVELS), 5)
    del scores
    log(f"[time] bitwise serving: sequential {seq_ms:.3f} ms/batch, pipelined {pipe_ms:.3f} "
        f"ms/batch (scan stage idle {100 * stats['device_idle_frac']:.0f}%), "
        f"{len(batches)} requests of {SERVE_Q} on {name} ({smi}); a request's split: "
        f"binary_dot {row['ms']:.3f} ms, select_topk (the stable sort of the [{SERVE_Q}, {N}] "
        f"scores) {sort_ms:.3f} ms, encode + pack {encode_ms:.3f} ms, the rest "
        f"{seq_ms - row['ms'] - sort_ms - encode_ms:.3f} ms of the sequential request")
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

    IVF_NLIST, IVF_NPROBE, IVF_SEED, IVF_KMEANS_ITERS = ivf_params()

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


def hnsw_phase(model, encode, eager, cfg, seed, device, name, smi):
    """Phase 8c: the HNSW graph search at the CLI's width. Returns its gather's JSON row
    and the corpus (host codes, query batches, their codes) with request 0's time."""
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
    from repro_torch.launch.serve import cli_builder, encode_codes, recall_at_k

    p = cli_builder("hnsw").params
    HNSW_M, HNSW_EF_CONSTRUCTION, HNSW_MAX_HOPS, HNSW_SEED = (p["M"], p["ef_construction"],
                                                              p["max_hops"], p["seed"])

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
        results, stats = serving.serve_batches(encode, search, batches, config=cfg)
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
    walls = {}
    for tag, t_ in (("int8", tbl), ("packed", tbl_p)):
        def request(t_=t_):
            return hl.search_hnsw_batched(t_, q, **skw)

        wall = walls[tag] = host_ms(request, 10)
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
    encode_repair("hnsw int8", encode, eager,
                  lambda q: hl.search_hnsw_batched(tables[False], q, **skw), batches, cfg, name,
                  smi)
    idx = torch.cat([i for _, i in out["int8"]["results"]], 0)
    idx_c = torch.cat([i for _, i in out[bigr_tag]["results"]], 0)
    log(f"[hnsw] recall@{K} against the positive doc (untrained weights, information only): "
        f"hnsw {recall_at_k(idx, gt):.4f}, bi-granular {recall_at_k(idx_c, gt):.4f}")
    log(f"[hnsw] phase passed in {time.perf_counter() - t_phase:.1f} s")
    row = dict(name="sdc_gather_topk_hnsw", route="cuda", source=GATHER_SOURCE,
               replaces=GATHER_REPLACES, launches=out["int8"]["gathers"],
               max_abs_err=out["int8"]["err"], ms=split["gather call"], plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=None)
    return row, dict(host=host, batches=batches, codes=codes_b, request_ms=walls["int8"],
                     iters=iters[0], tables=tables[False])


def in_gather_order(v, i, order, shard_n, k):
    """A flat search's list (ties toward the lower id) in the engine's merge
    order: score, then the leaf's place in ``order`` (``engine.gather_order``),
    then id; its first k."""
    import torch

    place = torch.tensor(order, device=i.device).argsort()
    leaf = (i.long() // shard_n).clamp(0, len(order) - 1)
    by_place = torch.sort(place[leaf], dim=1, stable=True).indices
    v, i = v.gather(1, by_place), i.gather(1, by_place)
    by_score = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return v.gather(1, by_score), i.gather(1, by_score)


def engine_phase(d_codes, indexes, encode, eager, batches, cfg, device, name, smi, hnsw):
    """Phase 8d: the distributed engine, four leaves on the card. Returns the
    JSON rows of the engine leaf's scan and the HNSW engine's hop."""
    import numpy as np
    import torch

    from repro_torch.core.binarize_lib import coarse_codes
    from repro_torch.index import engine as eng
    from repro_torch.index import hnsw_lite as hl
    from repro_torch.index.flat import BiGranularFlat, FlatSDC
    from repro_torch.kernels.sdc import gather as gather_mod
    from repro_torch.kernels.sdc import ops as ops_mod
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.rerank import sdc_rerank_backend
    from repro_torch.launch.lifecycle import CorpusSnapshot, EngineBuilder, builder_version
    from repro_torch.launch.mesh import make_host_mesh, make_replica_meshes
    from repro_torch.launch.serve import cli_builder

    t_phase = time.perf_counter()
    topk_fn, gather_fn, scores_fn = sdc_mod.sdc_topk, gather_mod.sdc_gather_topk, sdc_mod.sdc_scores
    mesh = make_host_mesh((2, 2), devices=[device] * ENGINE_LEAVES)
    order = eng.gather_order(mesh)
    N = d_codes.shape[0] - d_codes.shape[0] % ENGINE_LEAVES
    shard_n = N // ENGINE_LEAVES
    codes_b = [encode(b) for b in batches]
    t0 = time.perf_counter()
    snap = CorpusSnapshot(d_codes[:N], LEVELS, "v1")  # a view of the first N rows
    digest = snap.digest
    digest_s = time.perf_counter() - t0
    log(f"[engine] {ENGINE_LEAVES} leaves on {name} (LeafMesh (2, 2), merge order {order}), "
        f"{N} of the {d_codes.shape[0]} documents, {shard_n} a leaf; snapshot digest "
        f"{digest[:12]} in {digest_s:.2f} s (host copy + sha1)")

    def ties_checked(v, i, want, tag):
        """``want`` is a flat list with WIDE_MARGIN extra slots: every doc
        tied with the k-th must be in it."""
        wv, wi = want
        check(bool((wv[:, -1] < wv[:, K - 1]).all()),
              f"engine {tag}: a tie at the k-th score reaches past the flat list's margin")
        ev, ei = in_gather_order(wv, wi, order, shard_n, K)
        check(torch.equal(v, ev) and torch.equal(i, ei),
              f"engine {tag}: differs from the flat search in merge order")
        same = torch.equal(v, wv[:, :K]) and torch.equal(i, wi[:, :K])
        check(same or not (torch.equal(ev, wv[:, :K]) and torch.equal(ei, wi[:, :K])),
              f"engine {tag}: differs from the flat search where no tie is reordered")
        return same

    # -- the flat engine, int8 and packed, from EngineBuilder.build ------------
    flat_out, searches, builders = {}, {}, {}
    for packed in (False, True):
        tag = "packed" if packed else "int8"
        builders[packed] = EngineBuilder([mesh], index="flat", n_levels=LEVELS, k=K,
                                         packed=packed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        search = searches[packed] = builders[packed].build(snap)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        results, launches, seq_ms, pipe_ms, stats = serve_checked(
            f"engine flat {tag}", encode, search, batches, cfg, [(topk_fn, 4), (scores_fn, 0)])
        ref = FlatSDC(codes=indexes[packed].codes[:N], inv_norm=indexes[packed].inv_norm[:N],
                      n_levels=LEVELS, packed=packed)
        plain = eng.make_distributed_search(mesh, n_levels=LEVELS, k=K, packed=packed,
                                            backend="torch")
        flat_equal = 0
        for r, (c, (v, i)) in enumerate(zip(codes_b, results)):
            check(bool(((i >= 0) & (i < N)).all()), f"engine flat {tag}: ids out of range")
            flat_equal += ties_checked(v, i, ref.search(c, K + WIDE_MARGIN), f"flat {tag}")
        pv, pi = plain(codes_b[0], *search.leaf_inputs)
        v0, i0 = results[0]
        check(torch.equal(v0, pv) and torch.equal(i0, pi),
              f"engine flat {tag}: differs from the plain leaves on the card")
        flat_out[packed] = dict(results=results, launches=launches, seq_ms=seq_ms,
                                pipe_ms=pipe_ms, idle=stats["device_idle_frac"],
                                err=float((v0 - pv).abs().max()))
        log(f"[engine] flat {tag}: EngineBuilder.build in {build_s:.2f} s; {len(batches)} "
            f"requests of {SERVE_Q} served, 4 sdc_topk launches and no sdc_scores a request in "
            f"each run; bit-identical to serve_sequential, to FlatSDC.search over the same rows "
            f"with ties in merge order (and without reordering on {flat_equal} of "
            f"{len(batches)} requests), and to the plain leaves on request 0")
    for (a, b), (c, d) in zip(flat_out[False]["results"], flat_out[True]["results"]):
        check(torch.equal(a, c) and torch.equal(b, d), "engine: packed and int8 results differ")
    encode_repair("engine flat int8", encode, eager, searches[False], batches, cfg, name, smi)

    # -- failover: leaf 3 dead, then alive again, no rebuild --------------------
    search = searches[False]
    fo = eng.make_failover_search(mesh, n_levels=LEVELS, k=K)
    alive = torch.ones(ENGINE_LEAVES, dtype=torch.bool, device=device)
    alive[3] = False
    q0 = codes_b[0]
    topk_fn.launches = 0
    v, i = fo(q0, *search.leaf_inputs, alive)
    check(topk_fn.launches == ENGINE_LEAVES, "failover: a dead leaf still scans (SPMD), want 4")
    check(not bool(((i >= 3 * shard_n) & (i < 4 * shard_n)).any()),
          "failover: an id of the dead leaf 3 surfaced")
    inv = indexes[False].inv_norm[:N].clone()
    inv[3 * shard_n:] = 0
    want = ops_mod.sdc_search(q0, d_codes[:N], inv, n_levels=LEVELS, k=K + WIDE_MARGIN)
    ties_checked(v, i, want, "failover")
    alive[3] = True
    v, i = fo(q0, *search.leaf_inputs, alive)
    v0, i0 = flat_out[False]["results"][0]
    check(torch.equal(v, v0) and torch.equal(i, i0),
          "failover: the mask flipped back differs from the healthy engine")
    log("[engine] failover: leaf 3 dead, no id of its rows, bit-identical to ops.sdc_search "
        "with its inverse norms zeroed (ties in merge order); the mask flipped back (same "
        "closure, no rebuild) gives the healthy result")

    # -- bi-granular: a numpy snapshot, the coarse leaves, one rerank ----------
    C, kc = ENGINE_RERANK
    host = d_codes[:N].cpu().numpy()
    snap_h = CorpusSnapshot(host, LEVELS, "v1")
    check(snap_h.digest == snap.digest, "engine: the numpy snapshot's digest differs")
    builder_rr = EngineBuilder([mesh], index="flat", n_levels=LEVELS, k=K, packed=True,
                               coarse_levels=C, k_coarse=kc)
    t0 = time.perf_counter()
    search_rr = builder_rr.build(snap_h)
    torch.cuda.synchronize()
    rr_build_s = time.perf_counter() - t0
    rr_tag = f"bi-granular C={C} k'={kc} host tier"
    results, rr_launches, rr_seq, rr_pipe, rr_stats = serve_checked(
        f"engine {rr_tag}", encode, search_rr, batches, cfg,
        [(gather_fn, 1), (topk_fn, ENGINE_LEAVES), (scores_fn, 0)])
    # flat_search_from_snapshot's index over the same rows
    bigr = BiGranularFlat.build(host, LEVELS, coarse_levels=C, k_coarse=kc, packed=True,
                                device=device)
    rr_equal = 0
    for c, (v, i) in zip(codes_b, results):
        cv, ci = bigr.coarse.search(coarse_codes(c, LEVELS, C), kc + RERANK_MARGIN)
        check(bool((cv[:, -1] < cv[:, kc - 1]).all()),
              f"engine {rr_tag}: a coarse tie at k' reaches past the margin")
        _, cand = in_gather_order(cv, ci, order, shard_n, kc)
        ev, ei = sdc_rerank_backend(c, bigr.fine_codes, bigr.fine_inv_norm, cand,
                                    n_levels=LEVELS, k=K)
        check(torch.equal(v, ev) and torch.equal(i, ei),
              f"engine {rr_tag}: differs from the flat closure's rerank of the coarse "
              "survivors in merge order")
        fv, fi = bigr.search(c, K)
        same = torch.equal(v, fv) and torch.equal(i, fi)
        check(same or not (torch.equal(ev, fv) and torch.equal(ei, fi)),
              f"engine {rr_tag}: differs from the flat closure where no tie is reordered")
        rr_equal += same
    log(f"[engine] {rr_tag}: EngineBuilder.build in {rr_build_s:.2f} s; {len(batches)} "
        f"requests served, {ENGINE_LEAVES} coarse sdc_topk and 1 rerank sdc_gather_topk a "
        f"request in each run; bit-identical to the flat closure (BiGranularFlat, as "
        f"flat_search_from_snapshot builds it) on {rr_equal} of {len(batches)} requests, and "
        "to its rerank of the coarse survivors in merge order on all")
    del bigr, search_rr

    # -- two replicas on the card: shared leaf storage, one artifact -----------
    meshes = make_replica_meshes(2, (2, 2), devices=[device] * (2 * ENGINE_LEAVES))
    b2 = EngineBuilder(meshes, index="flat", n_levels=LEVELS, k=K, packed=True)
    reps = [b2.build(snap, replica=r) for r in (0, 1)]
    outs = [fn(q0) for fn in reps]
    v0, i0 = flat_out[True]["results"][0]
    check(all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
          and torch.equal(outs[0][0], v0) and torch.equal(outs[0][1], i0),
          "replicas: results differ")
    check(all([t.data_ptr() for t in a] == [t.data_ptr() for t in b]
              for a, b in zip(reps[0].leaf_inputs, reps[1].leaf_inputs)),
          "replicas: the leaf tensors are not shared")
    check(len(b2._flat_cache) == 1, "replicas: more than one artifact for the digest")
    tags = {builder_version(b, s).tag for b in (b2, builders[True]) for s in (snap, snap_h)}
    check(len(tags) == 1, f"replicas: builder_version tags differ: {tags}")
    log(f"[engine] two replicas (make_replica_meshes(2, (2, 2)) on one card): equal results, "
        f"the same leaf storage (data_ptr), one artifact for the digest, one tag {tags.pop()}")
    del reps, b2, builder_rr

    # -- the HNSW engine over phase 8c's corpus ---------------------------------
    host20, hb, hcodes = hnsw["host"], hnsw["batches"], hnsw["codes"]
    snap20 = CorpusSnapshot(host20, LEVELS, "v1")
    hp = cli_builder("hnsw", ef=HNSW_EF, beam=HNSW_BEAM).params
    gkw = dict(M=hp["M"], ef_construction=hp["ef_construction"], ef=hp["ef"], beam=hp["beam"],
               max_hops=hp["max_hops"], seed=hp["seed"])
    walk = hl.hnsw_frontier_search
    cpu_mesh = make_host_mesh((2, 2), devices=["cpu"] * ENGINE_LEAVES)
    h_out = {}
    for packed in (False, True):
        tag = "packed" if packed else "int8"
        b = EngineBuilder([mesh], index="hnsw", n_levels=LEVELS, k=K, packed=packed, **gkw)
        t0 = time.perf_counter()
        hsearch = b.build(snap20)
        torch.cuda.synchronize()
        hbuild_s = time.perf_counter() - t0
        tables = hsearch.leaf_inputs

        def leaf_iters(c):
            """Each leaf's hop iterations for query codes ``c``, walked alone."""
            out = []
            for leaf in range(ENGINE_LEAVES):
                t = [x[leaf] for x in tables]
                _, _, st = walk(c, *t[:5], t[5].reshape(-1), n_levels=LEVELS, k=K,
                                ef=max(hp["ef"], K), beam=hp["beam"], max_hops=hp["max_hops"],
                                backend="cuda", packed=packed)
                out.append(int(st["hops"].max()))
            return out

        iters = [leaf_iters(c) for c in hcodes]
        gathers = [sum(it) for it in iters]
        reads = [sum(n + (n < hp["max_hops"]) for n in it) for it in iters]
        results, hl_launches, hseq, hpipe, hstats = serve_checked(
            f"engine hnsw {tag}", encode, hsearch, hb, cfg,
            [(gather_fn, gathers), (topk_fn, ENGINE_LEAVES), (walk, reads, "host_reads"),
             (scores_fn, 0)])
        cpu_tables = [[t.cpu() for t in tbl] for tbl in tables]
        cpu_fn = eng.make_hnsw_search(cpu_mesh, n_levels=LEVELS, k=K, ef=hp["ef"],
                                      beam=hp["beam"], max_hops=hp["max_hops"], packed=packed)
        cv, ci = cpu_fn(hcodes[0].cpu(), *cpu_tables)
        v0, i0 = results[0]
        check(torch.equal(v0.cpu(), cv) and torch.equal(i0.cpu(), ci),
              f"engine hnsw {tag}: request 0 differs from the same engine on the CPU")
        for v, i in results:
            check(bool(((i >= 0) & (i < host20.shape[0])).all()),
                  f"engine hnsw {tag}: ids out of range")
        h_out[packed] = dict(results=results, search=hsearch, iters=iters, gathers=gathers,
                             seq_ms=hseq, pipe_ms=hpipe, idle=hstats["device_idle_frac"])
        log(f"[engine] hnsw {tag}: EngineBuilder.build (4 graphs of {host20.shape[0] // 4} on "
            f"the host, M {hp['M']}, ef_construction {hp['ef_construction']}) in "
            f"{hbuild_s:.2f} s; {len(hb)} requests of {SERVE_Q} at ef {hp['ef']}, beam "
            f"{hp['beam']}: hop iterations per leaf {iters}; in each run 4 sdc_topk, "
            f"{sum(gathers)} sdc_gather_topk launches (the summed iterations) and {sum(reads)} "
            "host reads; request 0 bit-identical to the same engine on the CPU")
    for (a, b), (c, d) in zip(h_out[False]["results"], h_out[True]["results"]):
        check(torch.equal(a, c) and torch.equal(b, d), "engine hnsw: packed and int8 differ")

    # -- times ----------------------------------------------------------------------
    q = codes_b[0]
    rows = []
    leaf_c, leaf_v = (t[0] for t in searches[False].leaf_inputs)
    lk = dict(n_levels=LEVELS, k=K, packed=False)
    leaf_ms = cuda_ms(lambda: topk_fn(q, leaf_c, leaf_v, **lk), 20)
    leaf_plain_ms = cuda_ms(lambda: sdc_mod.sdc_topk_torch(q, leaf_c, leaf_v, **lk), 3)
    lv, li = topk_fn(q, leaf_c, leaf_v, **lk)
    pv, pi = sdc_mod.sdc_topk_torch(q, leaf_c, leaf_v, **lk)
    check(torch.equal(lv, pv) and torch.equal(li, pi), "engine leaf: kernel != plain")
    nbytes = shard_n * (CODE_DIM + 4) + q.numel() + q.shape[0] * K * 8
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * q.shape[0] * shard_n * CODE_DIM / INT8_OPS_PER_S
    n8 = shard_n - shard_n % 8
    d8, inv8 = leaf_c[:n8], leaf_v[:n8]
    sq = q.to(torch.int32).sum(-1, keepdim=True)
    sd = d8.to(torch.int32).sum(-1)[None, :]

    def library():
        from repro_torch.core.binarize_lib import sdc_affine_epilogue
        dot = torch._int_mm(q, d8.t())
        s_ = sdc_affine_epilogue(dot, sq + sd, dim=CODE_DIM, n_levels=LEVELS,
                                 inv_norm=inv8[None, :])
        return torch.topk(s_, K)

    leaf_lib_ms = cuda_ms(library, 3)
    parts = [eng._leaf_scan(q, c, v, r * shard_n, n_levels=LEVELS, k=K, backend="cuda")
             for r, (c, v) in enumerate(zip(*searches[False].leaf_inputs))]
    merge_ms = cuda_ms(lambda: eng._merge(parts, order, K, device), 50)
    ref = FlatSDC(codes=indexes[False].codes[:N], inv_norm=indexes[False].inv_norm[:N],
                  n_levels=LEVELS)
    t_flat = [host_ms(lambda: ref.search(q, K), 10)]
    t_eng = [host_ms(lambda: searches[False](q), 10) for _ in range(2)]
    t_flat.append(host_ms(lambda: ref.search(q, K), 10))
    eng_busy = device_busy_ms(lambda: searches[False](q), 3)
    log(f"[time] engine leaf sdc_topk int8 Q={q.shape[0]} N={shard_n} D={CODE_DIM} k={K} on "
        f"{name} ({smi}): kernel {leaf_ms:.3f} ms, plain {leaf_plain_ms:.3f} ms, HBM bound "
        f"{bytes_ms:.4f} ms, int8 op bound {ops_ms:.4f} ms, library {leaf_lib_ms:.3f} ms; "
        f"merge of 4 x [{q.shape[0]}, {K}] {merge_ms:.4f} ms (CUDA events)")
    log(f"[time] engine flat int8 request ({ENGINE_LEAVES} leaves) against the single "
        f"FlatSDC request over the same {N} rows on {name} ({smi}), host clock synchronised, "
        f"flat/engine/engine/flat: {t_flat[0]:.3f} / {t_eng[0]:.3f} / {t_eng[1]:.3f} / "
        f"{t_flat[1]:.3f} ms; engine device busy "
        f"{eng_busy if isinstance(eng_busy, str) else f'{eng_busy:.4f} ms'} (profiler)")
    for packed, o in flat_out.items():
        log(f"[time] engine serving flat {'packed' if packed else 'int8'}: sequential "
            f"{o['seq_ms']:.3f} ms/batch, pipelined {o['pipe_ms']:.3f} ms/batch (scan stage "
            f"idle {100 * o['idle']:.0f}%), {len(batches)} requests of {SERVE_Q} on {name} "
            f"({smi})")
    log(f"[time] engine serving {rr_tag}: sequential {rr_seq:.3f} ms/batch, pipelined "
        f"{rr_pipe:.3f} ms/batch (scan stage idle {100 * rr_stats['device_idle_frac']:.0f}%) "
        f"on {name} ({smi})")
    rows.append(dict(name="sdc_topk_engine_leaf", route="cuda", source=SOURCE,
                     replaces=REPLACES[False], launches=flat_out[False]["launches"],
                     max_abs_err=float((lv - pv).abs().max()), ms=leaf_ms,
                     plain_ms=leaf_plain_ms, bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                     library_ms=leaf_lib_ms))

    # the HNSW engine: a request, its device share, and its hops' gathers
    hsearch, hq = h_out[False]["search"], hcodes[0]
    wall = host_ms(lambda: hsearch(hq), 10)
    busy = device_busy_ms(lambda: hsearch(hq), 3)
    share = "not measured" if isinstance(busy, str) else f"{100 * (1 - busy / wall):.1f}%"
    hops0 = h_out[False]["iters"][0]
    log(f"[time] hnsw engine request 0 int8 ({ENGINE_LEAVES} leaves, hop iterations {hops0}, "
        f"{sum(hops0)} gathers) on {name} ({smi}): {wall:.3f} ms (host clock, synchronised), "
        f"device busy {busy if isinstance(busy, str) else f'{busy:.4f} ms'} (profiler, every "
        f"kernel), device idle {share}; {wall / sum(hops0):.4f} ms per leaf hop; one graph "
        f"over the whole corpus (phase 8c) {hnsw['request_ms']:.3f} ms for {hnsw['iters']} "
        "hops")
    for packed, o in h_out.items():
        log(f"[time] engine serving hnsw {'packed' if packed else 'int8'}: sequential "
            f"{o['seq_ms']:.3f} ms/batch, pipelined {o['pipe_ms']:.3f} ms/batch (scan stage "
            f"idle {100 * o['idle']:.0f}%), {len(hb)} requests of {SERVE_Q} on {name} ({smi})")
    hops = []
    real = ops_mod.sdc_gather_topk

    def record(*a, **kw):
        hops.append((a, kw))
        return real(*a, **kw)

    ops_mod.sdc_gather_topk = record
    try:
        hsearch(hq)
    finally:
        ops_mod.sdc_gather_topk = real
    check(len(hops) == sum(hops0), f"hnsw engine: recorded {len(hops)} hops, want {sum(hops0)}")
    kms, pms, bms, err = [], [], [], 0.0
    n_bytes = n_ops = 0
    for a, kw in hops:
        kms.append(cuda_ms(lambda: real(*a, **kw), 10))
        pms.append(cuda_ms(lambda: gather_mod.sdc_gather_topk_torch(*a, **kw), 1))
        gv, gi = real(*a, **kw)
        tv, ti = gather_mod.sdc_gather_topk_torch(*a, **kw)
        check(torch.equal(gv, tv) and torch.equal(gi, ti), "hnsw engine hop: kernel != plain")
        err = max(err, float((gv - tv).abs().max()))
        qh, nbr_codes, probes, mask = a[0], a[1], a[4], kw["cand_mask"]
        live_slot = mask.any(-1)
        lists = int(torch.unique(probes[live_slot]).numel())
        live = int(mask.sum())
        m = nbr_codes.shape[1]
        b_ = (lists * m * (nbr_codes.shape[2] + 8) + mask.numel() * 4 + qh.numel()
              + probes.numel() * 8 + qh.shape[0] * kw["k"] * 8)
        n_bytes += b_
        n_ops += 2 * live * CODE_DIM
        bms.append(max(1e3 * b_ / HBM_BYTES_PER_S, 1e3 * 2 * live * CODE_DIM / INT8_OPS_PER_S))
    h_bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S / len(hops)
    h_ops_ms = 1e3 * n_ops / INT8_OPS_PER_S / len(hops)
    log(f"[time] hnsw engine hop gathers of request 0 int8 ({len(hops)} hops over the "
        f"{ENGINE_LEAVES} leaves) on {name} ({smi}): kernel {np.mean(kms):.4f} ms a hop (min "
        f"{min(kms):.4f}, max {max(kms):.4f}), plain {np.mean(pms):.3f} ms, bound "
        f"{np.mean(bms):.6f} ms a hop ({'bytes' if h_bytes_ms >= h_ops_ms else 'operations'}: "
        f"{n_bytes / len(hops) / 1e6:.4f} MB, {n_ops / len(hops) / 1e6:.3f} M int8 ops a hop)")
    rows.append(dict(name="sdc_gather_topk_hnsw_engine", route="cuda", source=GATHER_SOURCE,
                     replaces=GATHER_REPLACES, launches=sum(h_out[False]["gathers"]),
                     max_abs_err=err, ms=float(np.mean(kms)), plain_ms=float(np.mean(pms)),
                     bound_ms=float(np.mean(bms)),
                     bound_by="bytes" if h_bytes_ms >= h_ops_ms else "operations",
                     library_ms=None))
    log(f"[engine] phase passed in {time.perf_counter() - t_phase:.1f} s")
    return rows


def launches_per_call(fn, reps: int = 3):
    """Kernel launches one call of ``fn`` issues (runtime and driver launch
    calls, a CUDA graph's launch counting one, by torch.profiler) and the
    device kernels that ran, per call; or "not measured" where the profiler
    sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    calls = sum(ev.count for ev in events
                if (ev.key or "").startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                              "cudaGraphLaunch")))
    kernels = sum(ev.count for ev in events
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    return tuple(n / reps if n else "not measured" for n in (calls, kernels))


def routed_phase(d_codes, indexes, encode, eager, batches, cfg, device, name, smi, hnsw, rows):
    """Phase 8e: the replicated serving tier, through the CLI's routed run
    (``serve.serve_routed``) over phase 3's codes. Returns the JSON rows of
    the kernels' launches through the router."""
    import numpy as np
    import torch

    from repro_torch.index import hnsw_lite as hl
    from repro_torch.kernels.sdc import gather as gather_mod
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.launch import autoscale, faults, lifecycle, proxy, serving
    from repro_torch.launch.serve import cli_builder, serve_routed

    t_phase = time.perf_counter()
    topk, gather = sdc_mod.sdc_topk, gather_mod.sdc_gather_topk
    stream = batches * ROUTED_ROUNDS
    routed_launches = {False: 0, True: 0}
    searches = {p: (lambda q, index=index: index.search(q, K)) for p, index in indexes.items()}

    def held(tag, results, seq, allow_missed=False):
        """Every result bit-identical to serve_sequential's, in order; a
        missed deadline (None) only where allowed. Returns the missed count."""
        check(len(results) == len(seq), f"routed {tag}: {len(results)} results, want {len(seq)}")
        missed = 0
        for r, (sv, si) in zip(results, seq):
            if r is None:
                check(allow_missed, f"routed {tag}: a request was lost")
                missed += 1
                continue
            v, i = r
            check(v.shape == (SERVE_Q, K) and bool(torch.isfinite(v).all()),
                  f"routed {tag}: bad scores")
            check(torch.equal(v, sv) and torch.equal(i, si),
                  f"routed {tag}: results differ from serve_sequential")
        return missed

    def counted(search):
        """``search`` with its calls counted (a fault fires before the call)."""
        calls = [0]

        def fn(q):
            calls[0] += 1
            return search(q)

        return fn, calls

    def run_routed(tag, packed, search, stream_, want_launches, enc=encode, **kw):
        """serve_routed with the sdc_topk count zeroed just before and read
        just after; ``want_launches(run)`` is what the run must count."""
        topk.launches = 0
        run = serve_routed(enc, search, stream_, warm_batches=batches, device=device,
                           **{"config": cfg, **kw})
        got = topk.launches
        want = want_launches(run)
        check(got == want, f"routed {tag}: {got} sdc_topk launches, want {want}")
        routed_launches[packed] += got
        return run

    # -- (a) 1, 2 and 4 replicas, both policies, int8 and packed ------------------
    seqs, qps = {}, {}
    for packed, search in searches.items():
        tag = "packed" if packed else "int8"
        serving.warmup(encode, search, batches)
        topk.launches = 0
        t0 = time.perf_counter()
        seq = serving.serve_sequential(encode, search, stream)
        qps[tag, "sequential"] = SERVE_Q * len(stream) / (time.perf_counter() - t0)
        check(topk.launches == len(stream), f"routed {tag}: sequential baseline launched "
                                            f"{topk.launches} sdc_topk, want {len(stream)}")
        seqs[packed] = seq
        for policy in ROUTED_POLICIES:
            for n in ROUTED_REPLICAS:
                run = run_routed(f"{tag} x{n} {policy}", packed, search, stream,
                                 lambda run: len(stream), replicas=n, router=policy)
                held(f"{tag} x{n} {policy}", run.results, seq)
                st = run.stats
                check(st["requests"] == len(stream) and st["healthy"] == list(range(n))
                      and st["failovers"] == 0 and st["shed"] == 0,
                      f"routed {tag} x{n} {policy}: stats {st['requests']} requests, healthy "
                      f"{st['healthy']}, {st['failovers']} failovers, {st['shed']} shed")
                qps[tag, policy, n] = SERVE_Q * len(stream) / run.seconds
                log(f"[routed] {tag} x{n} {policy}: {len(stream)} requests of {SERVE_Q}, "
                    f"{len(stream)} sdc_topk launches, bit-identical to serve_sequential; "
                    f"per replica {[s['requests'] for s in st['per_replica']]} requests, "
                    f"p50 {st['latency_p50_ms']:.3f} ms p99 {st['latency_p99_ms']:.3f} ms")
    seq8, search8 = seqs[False], searches[False]
    seq_long = {r: seq8 * (r // ROUTED_ROUNDS) for r in (CHAOS_ROUNDS, AUTOSCALE_ROUNDS)}

    # -- the encode: the captured graph against its eager twin --------------------
    # every batch shape the phases serve (and a ragged tail, and one row),
    # bit for bit
    shapes = [b for b in batches] + [batches[0][:SERVE_Q - 23], batches[1][:1]]
    for b in shapes:
        check(torch.equal(encode(b), eager(b)),
              f"the captured encode differs from the eager one at batch {b.shape[0]}")
    log(f"[routed] the captured encode (one CUDA graph a batch shape; {encode.captures} "
        f"shapes captured so far) equals the eager twin bit for bit on {len(shapes)} batches "
        f"of {sorted({b.shape[0] for b in shapes})} queries")

    # the same matrix with the eager encode, int8: the repair's effect in one run
    for policy in ROUTED_POLICIES:
        serving.warmup(eager, search8, batches)
        t0 = time.perf_counter()
        serving.serve_sequential(eager, search8, stream)
        qps["int8 eager", "sequential"] = SERVE_Q * len(stream) / (time.perf_counter() - t0)
        for n in ROUTED_REPLICAS:
            run = run_routed(f"int8 eager x{n} {policy}", False, search8, stream,
                             lambda run: len(stream), enc=eager, replicas=n, router=policy)
            held(f"int8 eager x{n} {policy}", run.results, seq8)
            qps["int8 eager", policy, n] = SERVE_Q * len(stream) / run.seconds

    # -- the pipelined-vs-sequential gap: the encode inside a pipeline and alone ---
    for which, enc in (("captured", encode), ("eager", eager)):
        enc_s = []

        def timed_encode(x, enc=enc, enc_s=enc_s):
            t0 = time.perf_counter()
            y = enc(x)
            enc_s.append(time.perf_counter() - t0)
            return y

        topk.launches = 0
        run = serve_routed(timed_encode, search8, stream, warm_batches=batches, config=cfg,
                           device=device)
        routed_launches[False] += topk.launches
        held(f"encode split {which}", run.results, seq8)
        in_pipe = 1e3 * float(np.mean(enc_s))
        enc_s.clear()
        torch.cuda.synchronize()
        for b in stream:
            timed_encode(b)
        torch.cuda.synchronize()
        alone = 1e3 * float(np.mean(enc_s))
        synced = host_ms(lambda: enc(batches[0]), 20)
        enc_launches, enc_kernels = launches_per_call(lambda: enc(batches[0]))
        scan_launches, scan_kernels = launches_per_call(lambda: search8(enc(batches[0])))
        log(f"[time] routed encode {which} on {name} ({smi}): host issue {in_pipe:.4f} ms a "
            f"batch inside a replica pipeline (encode thread, beside the scan thread), "
            f"{alone:.4f} ms alone (the same calls back to back), {synced:.4f} ms alone with a "
            f"device sync; {enc_launches} launch calls and {enc_kernels} device kernels a "
            f"batch (profiler; encode and scan together: {scan_launches} and {scan_kernels})")
    for tag in ("int8", "packed", "int8 eager"):
        for policy in ROUTED_POLICIES:
            r1 = qps[tag, policy, 1] / qps[tag, "sequential"]
            rn = {n: qps[tag, policy, n] / qps[tag, policy, 1] for n in ROUTED_REPLICAS[1:]}
            log(f"[time] routed {tag} {policy} on {name} ({smi}): QPS sequential "
                f"{qps[tag, 'sequential']:.0f}, "
                + ", ".join(f"routed({n}) {qps[tag, policy, n]:.0f}" for n in ROUTED_REPLICAS)
                + f"; routed(1)/sequential {r1:.3f} (the reference gate asks >= "
                f"{GATE_SERVING_RATIO}), "
                + ", ".join(f"routed({n})/routed(1) {v:.3f}" for n, v in rn.items())
                + f" (the gate asks >= {GATE_REPLICA_RATIO}); report only")

    # -- (b) chaos: replica 1 fails its second scan, failover, canary revival -------
    long_b = batches * CHAOS_ROUNDS
    fn, calls = counted(search8)
    run = run_routed("chaos", False, fn, long_b, lambda run: calls[0], replicas=2,
                     chaos="r1.fail@1", probe_every=PROBE_EVERY_S)
    held("chaos", run.results, seq_long[CHAOS_ROUNDS])
    st, fired = run.stats, run.injectors[1].log
    check(fired == [("search", 1, "fail")], f"routed chaos: faults fired {fired}")
    check(st["failovers"] >= 1 and st["revivals"] >= 1 and st["healthy"] == [0, 1],
          f"routed chaos: {st['failovers']} failovers, {st['revivals']} revivals, healthy "
          f"{st['healthy']}")
    log(f"[routed] chaos r1.fail@1, probe every {PROBE_EVERY_S} s: {len(long_b)} requests, zero "
        f"lost, bit-identical; {st['failovers']} failover(s), {st['revivals']} revival(s) by "
        f"the canary probe, states {st['states']}; {calls[0]} scan calls went through and "
        f"{calls[0]} sdc_topk launches (the failed call launched none)")

    # -- (c) a stuck scan the watchdog fails over, under a deadline ------------------
    # Two replicas that do not share the device gate, admitting under the
    # shed policy, as the reference tier needs too: a scan stuck while it
    # holds the gate stalls every co-located replica with it, and their
    # watchdogs fail them all; and a blocking submit into the stuck
    # replica's full queue would wait for it however the router fails it
    # over. A shed submit bounces to the survivor and is retried.
    fn, calls = counted(search8)
    replicas, injectors = faults.apply_chaos([(encode, fn)] * 2, "r1.stick@1")
    shed_cfg = serving.ServingConfig(queue_depth=cfg.queue_depth, policy="shed")
    tier = proxy.QueryRouter(proxy.ReplicaSet(replicas, config=shed_cfg, share_device=False))
    topk.launches = 0
    try:
        tier.start_watchdogs(WATCHDOG_BUDGET_S)
        t0 = time.perf_counter()
        results, _ = lifecycle.run_stream_with_swap(tier, stream, deadline_s=DEADLINE_S)
        dt_stick = time.perf_counter() - t0
    finally:
        for inj in injectors.values():
            inj.release()
        tier.close()
    st = tier.stats()
    check(topk.launches == calls[0], f"routed watchdog: {topk.launches} launches for "
                                     f"{calls[0]} scan calls")
    routed_launches[False] += topk.launches
    missed = held("watchdog", results, seq8, allow_missed=True)
    check(injectors[1].stuck_count == 1 and st["watchdog_stalls"] >= 1 and st["failovers"] >= 1
          and st["states"][1] == "unhealthy",
          f"routed watchdog: {injectors[1].stuck_count} stuck, {st['watchdog_stalls']} stalls, "
          f"{st['failovers']} failovers, states {st['states']}")
    check(missed <= st["deadline_expired"], "routed watchdog: a missed request was not counted")
    log(f"[routed] r1.stick@1 under a {WATCHDOG_BUDGET_S} s scan budget and a {DEADLINE_S} s "
        f"deadline, unshared replicas, shed admission: {len(stream)} requests in "
        f"{1e3 * dt_stick:.1f} ms, {st['shed']} proxy sheds retried, "
        f"{len(stream) - missed} answered bit-identical, {missed} missed their deadline; "
        f"{st['watchdog_stalls']} stall(s), {st['failovers']} failover(s), {st['deadline_expired']}"
        f" expired (stale copies included), states {st['states']}")

    # -- (d) a rolling swap mid-stream from a snapshot of the same codes --------------
    t0 = time.perf_counter()
    snapshot = lifecycle.CorpusSnapshot(codes=d_codes.cpu().numpy(), n_levels=LEVELS,
                                        embedding_version="v1")
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snapshot.digest  # hashed once here, then cached
    digest_s = (digest_s, time.perf_counter() - t0)
    builder = cli_builder("flat", k=K, device=device)
    # the stream, and per replica a warmup of both drivers and a canary
    run = run_routed("swap", False, search8, stream, lambda run: len(stream) + 3 * 2,
                     replicas=2, builder=builder, snapshot=snapshot, swap_after=SWAP_AFTER)
    held("swap", run.results, seq8)
    rep = run.swap
    check(rep is not None and rep.swapped == 2 and run.stats["states"] == {0: "healthy",
                                                                            1: "healthy"},
          "routed swap: the swap did not complete on both replicas")
    check([p["version"] for p in run.stats["per_replica"]] == [rep.version.tag] * 2,
          "routed swap: a replica does not serve the new version")
    log(f"[routed] rolling swap after {SWAP_AFTER} of {len(stream)} requests -> "
        f"{rep.version.tag}: zero lost, bit-identical; host copy {digest_s[0]:.2f} s, digest "
        f"{digest_s[1]:.2f} s of {d_codes.numel() / 1e9:.2f} GB")
    for row in rep.replicas:
        log(f"[time] routed swap replica {row['replica']} on {name} ({smi}): drain "
            f"{1e3 * row['drain_s']:.1f} ms, build {1e3 * row['build_s']:.1f} ms, warm "
            f"{1e3 * row['warm_s']:.1f} ms, probe {1e3 * row['probe_s']:.1f} ms, total "
            f"{1e3 * row['total_s']:.1f} ms (generation {row['generation']})")
    del builder, run  # frees the rebuilt index
    torch.cuda.empty_cache()

    # -- (e) the autoscaler, min 1 and max 3 replicas, under the stream's own load ----
    spec = autoscale.TierSpec(min_replicas=1, max_replicas=3, index="flat",
                              build_params={"k": K}, router="least-outstanding", policy="shed",
                              queue_depth=2, high_water=0.5, low_water=0.1, cooldown_s=0.05,
                              window_s=0.02, tick_s=0.01)
    long_e = batches * AUTOSCALE_ROUNDS
    run = run_routed(
        "autoscale", False, search8, long_e,
        lambda run: len(long_e) + 3 * (run.autoscale["scale_ups"]
                                       + run.autoscale["probe_failures"]),
        replicas=spec.min_replicas, router=spec.router, spec=spec, snapshot=snapshot,
        config=serving.ServingConfig(queue_depth=spec.queue_depth, policy=spec.policy))
    held("autoscale", run.results, seq_long[AUTOSCALE_ROUNDS])
    sm = run.autoscale
    check(spec.min_replicas <= sm["min_replicas_seen"] and sm["max_replicas_seen"]
          <= spec.max_replicas and spec.min_replicas <= sm["replicas"] <= spec.max_replicas,
          f"routed autoscale: replicas seen [{sm['min_replicas_seen']}, "
          f"{sm['max_replicas_seen']}], ended at {sm['replicas']}")
    log(f"[routed] autoscaler spec [{spec.min_replicas}, {spec.max_replicas}] under "
        f"{len(long_e)} requests (shed policy, queue depth {spec.queue_depth}): zero lost, "
        f"bit-identical; {sm['scale_ups']} scale-up(s), {sm['scale_downs']} scale-down(s), "
        f"{sm['probe_failures']} failed canaries over {sm['decisions']} ticks; replicas seen "
        f"[{sm['min_replicas_seen']}, {sm['max_replicas_seen']}], ended at {sm['replicas']}; "
        f"{run.stats['shed']} sheds retried; {1e3 * run.seconds / len(long_e):.3f} ms/batch")
    del run, snapshot
    torch.cuda.empty_cache()

    # -- (f) two replicas over phase 8c's HNSW closure -------------------------------
    tbl, hb = hnsw["tables"], hnsw["batches"][:2]
    max_hops = cli_builder("hnsw").params["max_hops"]

    def search_h(q):
        return hl.search_hnsw_batched(tbl, q, k=K, ef=HNSW_EF, beam=HNSW_BEAM,
                                      max_hops=max_hops)

    serving.warmup(encode, search_h, hb)
    topk.launches = gather.launches = 0
    seq_h = serving.serve_sequential(encode, search_h, hb)
    want = (topk.launches, gather.launches)
    topk.launches = gather.launches = 0
    run = serve_routed(encode, search_h, hb, warm_batches=hb, replicas=2, config=cfg,
                       device=device)
    got = (topk.launches, gather.launches)
    check(got == want and min(got) > 0,
          f"routed hnsw: (sdc_topk, sdc_gather_topk) launches {got}, want {want}")
    held("hnsw", run.results, seq_h)
    check(run.stats["per_replica"][0]["requests"] == run.stats["per_replica"][1]["requests"] == 1,
          "routed hnsw: round-robin did not use both replicas")
    log(f"[routed] hnsw x2 round-robin: {len(hb)} requests of {SERVE_Q}, {got[0]} sdc_topk and "
        f"{got[1]} sdc_gather_topk launches as in serve_sequential, bit-identical")
    log(f"[routed] phase passed in {time.perf_counter() - t_phase:.1f} s")

    base = {r["name"]: r for r in rows}
    return ([dict(base[f"sdc_topk_{'packed' if p else 'int8'}"],
                  name=f"sdc_topk_{'packed' if p else 'int8'}_routed", launches=n)
             for p, n in routed_launches.items()]
            + [dict(base["sdc_gather_topk_hnsw"], name="sdc_gather_topk_hnsw_routed",
                    launches=got[1])])


def autotune_phase(d_codes, indexes, encode, batches, device, name, smi):
    """Phase 8f: the autotuner (``launch/autotune.py``) over the corpus codes,
    in a temporary cache directory: the scan at the flat path's signature,
    int8 and packed, and at an engine leaf's rows; the rerank at k'. Every
    candidate against the default plan, exactly; tuned <= default; a cache
    hit; the tuned plan through FlatSDC and the flat engine."""
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.index import engine as eng
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.defaults import BlockPlan
    from repro_torch.kernels.sdc.ops import sdc_search_backend
    from repro_torch.kernels.sdc.rerank import sdc_rerank_gathered
    from repro_torch.launch import autotune
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    topk = sdc_mod.sdc_topk
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cache = tempfile.mkdtemp(prefix="chip_smoke_tune_", dir=os.path.join(ROOT, "build"))
    N = d_codes.shape[0]
    leaf_n = (N - N % ENGINE_LEAVES) // ENGINE_LEAVES
    codes_b = [encode(b) for b in batches]
    real_q = codes_b[0]
    fine_host = d_codes.cpu().numpy()
    fine_inv = indexes[False].inv_norm.cpu().numpy()
    try:
        sigs = [("scan", False, N, K), ("scan", True, N, K), ("scan", False, leaf_n, K),
                ("rerank", False, N, TUNE_RERANK_KC)]
        plans = {}
        for kind, packed, n, k in sigs:
            tag = f"{kind} {'packed' if packed else 'int8'} N={n} k={k}"
            kw = dict(code_dim=CODE_DIM, n_shard=n, packed=packed, k=k, n_levels=LEVELS)
            t0 = time.perf_counter()
            tp = autotune.tuned_block_plan(kind, cache_dir=cache, sample_q=SERVE_Q,
                                           reps=TUNE_REPS, device=device, **kw)
            sweep_s = time.perf_counter() - t0
            check(tp.tuned and tp.plan.source == "tuned", f"autotune {tag}: not swept")
            payload = json.loads(open(tp.path).read())
            check(payload["tuned_ms"] <= payload["default_ms"],
                  f"autotune {tag}: tuned {payload['tuned_ms']} ms > default "
                  f"{payload['default_ms']} ms")
            again = autotune.tuned_block_plan(kind, cache_dir=cache, sample_q=SERVE_Q,
                                              device=device, **kw)
            check(not again.tuned and again.plan.source == "cache"
                  and again.plan.blocks() == tp.plan.blocks(),
                  f"autotune {tag}: the second call was not a cache hit")
            grid = [(c["block_q"], c["block_n"]) for c in payload["candidates"]]
            # every candidate against the default plan, on the sweep's own
            # operands and on real queries
            ops = autotune._sweep_operands(kind, sample_q=SERVE_Q, device=device, **kw)
            if kind == "scan":
                q_s, d_s, inv_s = ops
                d_r, inv_r = indexes[packed].codes[:n], indexes[packed].inv_norm[:n]

                def run(blocks, q, d, inv, packed=packed, k=k):
                    return sdc_search_backend(q, d, inv, n_levels=LEVELS, k=k, packed=packed,
                                              block_plan=BlockPlan("scan", *blocks))

                cases = ((q_s, d_s, inv_s), (real_q, d_r, inv_r))
            else:
                q_s, f_s, finv_s, cand_s = ops
                cand_r = indexes[False].search(real_q, k)[1].cpu().numpy()

                def run(blocks, q, f, finv, cand, k=k):
                    return sdc_rerank_gathered(q, f, finv, cand, n_levels=LEVELS, k=K,
                                               group=blocks[1])

                cases = ((q_s, f_s, finv_s, cand_s), (real_q, fine_host, fine_inv, cand_r))
            for case in cases:
                want = run(grid[0], *case)
                for blocks in grid[1:]:
                    got = run(blocks, *case)
                    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"autotune {tag}: candidate {blocks} differs from the default plan")
            del ops, cases
            plans[kind, packed, n] = tp.plan
            cands = "; ".join(
                f"({c['block_q']}, {c['block_n']})"
                + (f" -> grid {c['launched'][0]}q x {c['launched'][1]} slices of "
                   f"{c['launched'][2]}" if c["launched"] else "")
                + f" {c['ms']:.4f} ms" for c in payload["candidates"])
            log(f"[time] autotune {tag} (sample_q {SERVE_Q}, median of {TUNE_REPS}) on {name} "
                f"({smi}): {cands}; default {payload['default_ms']:.4f} ms, tuned "
                f"{payload['tuned_ms']:.4f} ms -> {tp.plan.blocks()}; sweep "
                f"{payload['sweep_s']:.2f} s ({sweep_s:.2f} s with the operands), cache hit "
                f"on the second call; every candidate bit-identical to the default on the sweep "
                f"operands and on {SERVE_Q} real queries")

        # the tuned plans through FlatSDC and the flat engine, 8 requests each
        for packed in (False, True):
            tag = "packed" if packed else "int8"
            plan = plans["scan", packed, N]
            index = indexes[packed]
            for c in codes_b:
                dv, di = index.search(c, K)
                default_geom = topk.last_geometry
                tv, ti = index.search(c, K, block_plan=plan)
                check(torch.equal(tv, dv) and torch.equal(ti, di),
                      f"autotune: FlatSDC {tag} with the tuned plan differs from the default")
                check(topk.last_geometry == sdc_mod.scan_geometry(
                    SERVE_Q, N, CODE_DIM, packed, K, device, plan.blocks()),
                    f"autotune: FlatSDC {tag} did not launch the tuned plan's grid")
            d_ms = cuda_ms(lambda: index.search(codes_b[0], K), 20)
            t_ms = cuda_ms(lambda: index.search(codes_b[0], K, block_plan=plan), 20)
            log(f"[time] autotune FlatSDC {tag} request on {name} ({smi}): default plan "
                f"{d_ms:.4f} ms (grid {default_geom}), tuned {plan.blocks()} {t_ms:.4f} ms "
                f"(grid {topk.last_geometry}); {len(codes_b)} requests bit-identical")
        mesh = make_host_mesh((2, 2), devices=[device] * ENGINE_LEAVES)
        rows = leaf_n * ENGINE_LEAVES
        leaf_plan = plans["scan", False, leaf_n]
        prepared = eng.flat_engine_inputs_from_snapshot(d_codes[:rows], LEVELS, device=device)
        default_eng = eng.engine_search_from_snapshot(mesh, d_codes[:rows], LEVELS, k=K,
                                                      prepared=prepared)
        tuned_eng = eng.engine_search_from_snapshot(mesh, d_codes[:rows], LEVELS, k=K,
                                                    prepared=prepared,
                                                    block_plan={"scan": leaf_plan})
        for c in codes_b:
            dv, di = default_eng(c)
            topk.launches = 0
            tv, ti = tuned_eng(c)
            check(topk.launches == ENGINE_LEAVES and topk.last_geometry == sdc_mod.scan_geometry(
                SERVE_Q, leaf_n, CODE_DIM, False, K, device, leaf_plan.blocks()),
                "autotune: the engine's leaves did not launch the tuned plan's grid")
            check(torch.equal(tv, dv) and torch.equal(ti, di),
                  "autotune: the flat engine with the tuned plan differs from the default")
        d_ms = cuda_ms(lambda: default_eng(codes_b[0]), 10)
        t_ms = cuda_ms(lambda: tuned_eng(codes_b[0]), 10)
        log(f"[time] autotune engine (4 leaves of {leaf_n}) request on {name} ({smi}): default "
            f"{d_ms:.4f} ms, tuned {leaf_plan.blocks()} {t_ms:.4f} ms; {len(codes_b)} requests "
            f"bit-identical, {ENGINE_LEAVES} sdc_topk launches each at the plan's grid")
        del default_eng, tuned_eng, prepared
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log(f"[autotune] phase passed in {time.perf_counter() - t_phase:.1f} s")


def _flat_tree(tree, prefix=""):
    """A nested dict/list of arrays as {"W/0/in/b": array}, dict keys sorted."""
    import numpy as np

    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _state_errors(start, card, host, cfg):
    """One step from ``start`` (``train_state_to_numpy``) on the card
    against the same step on the CPU, as the tests hold the port against
    the reference, each leaf against its own largest entry on the CPU:
    Adam's moments (the bias that batch norm follows, ``in.b``, against
    its MLP's ``in.w``, after checking that its gradient is rounding noise,
    at most STEP_TOL of that leaf); the card's parameters against Adam's
    update of ``start`` from the card's own moments, and its momentum copy
    against the EMA towards them (so a parameter is held as far as its
    gradient determines it, with no allowance); the running statistics.
    Returns a dict of the largest relative differences and whether the
    queue is exact and every ``in.b`` gradient noise."""
    import numpy as np

    from repro_torch.core import trainer as T

    a, b = T.train_state_to_numpy(card), T.train_state_to_numpy(host)
    f32, adam = np.float32, cfg.adam
    assert adam.weight_decay == 0 and adam.schedule is None
    step = int(a.opt_state.step)
    bc1, bc2 = f32(1) - f32(adam.b1) ** f32(step), f32(1) - f32(adam.b2) ** f32(step)
    p0, m0 = _flat_tree(start.params), _flat_tree(start.m_params)
    out = {"noise": True}
    for name in ("mu", "nu"):
        x, y = _flat_tree(getattr(a.opt_state, name)), _flat_tree(getattr(b.opt_state, name))
        worst = 0.0
        for k in y:
            scale = float(np.abs(y[k[:-1] + "w" if k.endswith("in/b") else k]).max())
            if k.endswith("in/b"):
                out["noise"] &= float(np.abs(y[k]).max()) <= STEP_TOL * scale
            worst = max(worst, float(np.abs(x[k] - y[k]).max()) / max(scale, 1e-30))
        out[name] = worst
    mu, nu = _flat_tree(a.opt_state.mu), _flat_tree(a.opt_state.nu)
    params, host_p = _flat_tree(a.params), _flat_tree(b.params)
    want = {k: p0[k] - f32(adam.lr) * ((mu[k] / bc1) / (np.sqrt(nu[k] / bc2) + f32(adam.eps)))
            for k in p0}
    out["params"] = max(float(np.abs(params[k] - want[k]).max()) / float(np.abs(host_p[k]).max())
                        for k in want)
    m_params, host_m = _flat_tree(a.m_params), _flat_tree(b.m_params)
    out["m_params"] = max(
        float(np.abs(m_params[k] - (f32(cfg.ema_decay) * m0[k]
                                    + f32(1.0 - cfg.ema_decay) * params[k])).max())
        / float(np.abs(host_m[k]).max()) for k in m0)
    for name, field in (("stats", "bn_state"), ("m_stats", "m_bn_state")):
        x, y = _flat_tree(getattr(a, field)), _flat_tree(getattr(b, field))
        out[name] = max(float(np.abs(x[k] - y[k]).max()) / float(np.abs(y[k]).max()) for k in y)
    out["queue"] = all(np.array_equal(np.asarray(a.queue[k]), np.asarray(b.queue[k]))
                       for k in b.queue)
    return out


def training_phase(seed, device, name, smi):
    """Phase 10: binarizer training at the reference CLI's width, then the
    CLI's upgrade through the routed tier. Returns the JSON row of
    sdc_topk on this path (its launches in the upgrade's routed run, its
    times at the trained index's shape)."""
    import copy
    import shutil
    import tempfile

    import torch

    from repro_torch.core import binarize_lib as B
    from repro_torch.core import trainer as T
    from repro_torch.data import synthetic as S
    from repro_torch.index.flat import FlatFloat, FlatSDC
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.launch import lifecycle, proxy, serving
    from repro_torch.launch.serve import (
        bc_train_binarizer,
        cli_builder,
        cli_train_config,
        encode_codes,
        recall_at_k,
        serve_routed,
        train_binarizer,
    )

    t_phase = time.perf_counter()
    topk = sdc_mod.sdc_topk
    cfg = cli_train_config(DIM, CODE_DIM, LEVELS)
    docs, queries, gt = S.clustered_corpus(seed, TRAIN_DOCS, TRAIN_QUERIES, DIM)
    log(f"[train] the CLI's corpus: {TRAIN_DOCS} x {DIM} (numpy), {TRAIN_QUERIES} queries; "
        f"binarizer {cfg.binarizer.total_bits} bits, hidden {cfg.binarizer.hidden_dim}, queue "
        f"{cfg.queue.length} x {cfg.queue.dim} mining the top {cfg.queue.top_k}, batch "
        f"{TRAIN_BATCH}, {TRAIN_STEPS} steps")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_", dir=os.path.join(ROOT, "build"))

    def leaves(model):
        return list(B.param_leaves(model).values()) + list(B.state_leaves(model).values())

    def identical(a, b):
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    try:
        # -- (a) two trainings from one seed, then a cache hit ---------------------
        runs = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck = train_binarizer(docs, cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seed=seed,
                                 cache_dir=os.path.join(cache, str(i)), device=device)
            torch.cuda.synchronize()
            runs.append((ck, time.perf_counter() - t0))
            check(ck.trained, f"training run {i} was a cache hit")
        (first, wall0), (second, wall1) = runs
        check(first.digest == second.digest, "two runs of one training digest differently")
        check(identical(first.model, second.model),
              "two card trainings from one seed are not bit-identical")
        t0 = time.perf_counter()
        hit = train_binarizer(docs, cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seed=seed,
                              cache_dir=os.path.join(cache, "0"), device=device)
        hit_s = time.perf_counter() - t0
        check(not hit.trained and hit.digest == first.digest and identical(hit.model, first.model),
              "the third call is not a bit-identical cache hit")
        log(f"[train] (a) {TRAIN_STEPS} steps on the card twice from seed {seed}: {wall0:.2f} s, "
            f"{wall1:.2f} s wall (pairs drawn in numpy and uploaded), bit-identical weights and "
            f"statistics; digest {first.digest}; the third call a bit-identical cache hit in "
            f"{1e3 * hit_s:.1f} ms")

        # -- (b) one step on the card against the port's CPU step ------------------
        state = T.init_train_state(cfg, torch.Generator(device=device).manual_seed(seed), device)
        gen = S.pair_batches(docs, seed + 1, TRAIN_BATCH, device=device)
        for _ in range(STEP_WARM):
            state, _ = T.train_step(state, *next(gen), cfg)
        tree = T.train_state_to_numpy(state)
        a, p = next(gen)
        rows, set_aside = torch.arange(TRAIN_BATCH), 0
        flips = edges = 0
        ste = B.ste_sign
        for _ in range(4):
            codes, windows = [], []
            for dev in (device, "cpu"):
                st = T.train_state_from_numpy(tree, cfg, dev)
                seen = []
                # the STE's gradient window |h| <= 1 of each level, read
                # from the online encoder's pre-activations
                B.ste_sign = lambda h: (seen.append((h.abs() <= 1).cpu()), ste(h))[1]
                try:
                    with torch.no_grad():
                        codes.append(torch.cat(
                            [B.binarize(st.m_model, p[rows].to(dev), train=True)[1],
                             B.binarize(st.model, a[rows].to(dev), train=True)[1]], 1).cpu())
                finally:
                    B.ste_sign = ste
                windows.append(torch.cat(seen[LEVELS:], 1))
            differ, edge = codes[0] != codes[1], windows[0] != windows[1]
            flips, edges = flips + int(differ.sum()), edges + int(edge.sum())
            bad = differ.any(1) | edge.any(1)
            if not bool(bad.any()):
                break
            rows, set_aside = rows[~bad], set_aside + int(bad.sum())
        check(not bool(bad.any()), "card and CPU codes still differ after setting rows aside")
        check(flips <= 1e-3 * 2 * TRAIN_BATCH * CODE_DIM,
              f"{flips} codes differ between the card and the CPU (TF32?)")
        check(edges <= 1e-3 * TRAIN_BATCH * LEVELS * CODE_DIM,
              f"{edges} STE windows differ between the card and the CPU (TF32?)")
        card = T.train_state_from_numpy(tree, cfg, device)
        host = T.train_state_from_numpy(tree, cfg, "cpu")
        card, cm = T.train_step(card, a[rows], p[rows], cfg)
        host, hm = T.train_step(host, a[rows].cpu(), p[rows].cpu(), cfg)
        loss_err = abs(float(cm["loss"]) - float(hm["loss"])) / abs(float(hm["loss"]))
        norm_err = abs(float(cm["grad_norm"]) - float(hm["grad_norm"])) / float(hm["grad_norm"])
        err = _state_errors(tree, card, host, cfg)
        check(loss_err <= STEP_TOL and norm_err <= STEP_TOL,
              f"card step: loss {loss_err:.2e}, gradient norm {norm_err:.2e} from the CPU's")
        check(max(err["mu"], err["nu"], err["params"], err["m_params"], err["stats"],
                  err["m_stats"]) <= STEP_TOL and err["noise"] and err["queue"],
              f"card step differs from the CPU's: {err}")
        log(f"[train] (b) one step after {STEP_WARM} on the card against the CPU's from the same "
            f"state and batch ({len(rows)} rows; {set_aside} set aside where {flips} codes took "
            f"the other sign or {edges} pre-activations the other side of the STE's |h| <= 1, "
            f"within rounding of the edge): loss {loss_err:.2e}, gradient norm {norm_err:.2e}, "
            f"gradients (Adam's moments, each leaf against its largest entry; in.b's, rounding "
            f"noise, against in.w's) {err['mu']:.2e} / {err['nu']:.2e}, parameters against "
            f"Adam's update from the card's moments {err['params']:.2e} (momentum copy against "
            f"its EMA {err['m_params']:.2e}), statistics {err['stats']:.2e} / "
            f"{err['m_stats']:.2e}, queue exact; tolerance {STEP_TOL}")

        # -- (c) recall@10: trained, untrained, float ----------------------------------
        untrained = B.init_binarizer(cfg.binarizer,
                                     torch.Generator(device=device).manual_seed(seed), device)
        recalls, searches = {}, 0
        topk.launches = 0
        for tag, model in (("trained", first.model), ("untrained", untrained)):
            index = FlatSDC.build(encode_codes(model, docs), LEVELS, device=device)
            recalls[tag] = recall_at_k(index.search(B.make_encode_fn(model)(queries), K)[1], gt)
            searches += 1
        check(topk.launches >= searches, f"(c) launched sdc_topk {topk.launches} times")
        recalls["float"] = recall_at_k(
            FlatFloat.build(docs, device=device).search(queries, K)[1], gt)
        check(not identical(first.model, untrained),
              "the trained weights equal the initial weights of the same seed")
        check(abs(recalls["trained"] - REF_CLI_RECALL) <= RECALL_MARGIN,
              f"trained recall {recalls['trained']:.4f} is not within {RECALL_MARGIN} of the "
              f"reference's {REF_CLI_RECALL}")
        log(f"[train] (c) recall@{K} over {TRAIN_QUERIES} queries, FlatSDC through sdc_topk "
            f"({topk.launches} launches): trained {recalls['trained']:.4f}, untrained (seed "
            f"{seed}) {recalls['untrained']:.4f}, float {recalls['float']:.4f}; the reference's "
            f"trained {REF_CLI_RECALL} (held to within {RECALL_MARGIN}) and untrained "
            f"{REF_UNTRAINED_RECALL} (reference_figures/cli_recall.py); trained / float "
            f"{recalls['trained'] / recalls['float']:.3f}")
        claims = _paper_claims(seed, device)
        log(f"[train] (c) the reference tests' claims on the card (1,024 queries): "
            f"{claims['system']}; {claims['compat']}")

        # -- (d) the upgrade through the routed tier, 2 replicas on the card --------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_docs = S.backbone_upgrade(docs, 5)
        new_queries = S.backbone_upgrade(queries, 5)
        bc = bc_train_binarizer(first.model, docs, new_docs, cfg, steps=TRAIN_STEPS,
                                batch=TRAIN_BATCH, device=device).model
        torch.cuda.synchronize()
        bc_wall = time.perf_counter() - t0
        enc_v1, enc_v2 = B.make_encode_fn(first.model), B.make_encode_fn(bc)
        builder = cli_builder("flat", k=K, device=device)
        snaps = {v: lifecycle.CorpusSnapshot(codes=encode_codes(m, d).cpu().numpy(),
                                             n_levels=LEVELS, embedding_version=v)
                 for v, m, d in (("v1", first.model, docs), ("v2", bc, new_docs))}
        search_v1, search_v2 = builder.build(snaps["v1"]), builder.build(snaps["v2"])
        bc_recall = recall_at_k(search_v1(enc_v2(new_queries))[1], gt)
        warm_recall = recall_at_k(search_v1(enc_v1(new_queries))[1], gt)
        check(not identical(bc, first.model),
              "BC training left the warm-started v1 weights unchanged")
        check(abs(bc_recall - REF_BC_RECALL) <= RECALL_MARGIN,
              f"BC recall on v1 {bc_recall:.4f} is not within {RECALL_MARGIN} of the "
              f"reference's {REF_BC_RECALL}")
        compat = proxy.CompatibilityMatrix()
        compat.register("v2", "v1", enc_v2)
        compat.register("v1", "v2", enc_v1)
        n_up = SERVE_Q * SERVE_REQUESTS
        batches = [queries[i:i + SERVE_Q] for i in range(0, n_up, SERVE_Q)]
        new_batches = [new_queries[i:i + SERVE_Q] for i in range(0, n_up, SERVE_Q)]
        stream, meta = [], []
        for _ in range(ROUTED_ROUNDS):
            for b, nb in zip(batches, new_batches):
                stream += [serving.SearchRequest(queries=b, embedding_version="v1"),
                           serving.SearchRequest(queries=nb, embedding_version="v2")]
                meta += [(enc_v1, b), (enc_v2, nb)]
        serving.warmup(enc_v1, search_v1, batches)
        serving.warmup_replicas([(enc_v2, search_v1)], batches[:1])
        topk.launches = 0
        run = serve_routed(enc_v1, search_v1, stream, warm_batches=batches,
                           replicas=UPGRADE_REPLICAS, builder=builder, snapshot=snaps["v2"],
                           swap_after=UPGRADE_AFTER, compat=compat, swap_encode=enc_v2,
                           embedding_version="v1", device=device)
        upgrade_launches = topk.launches
        check(len(run.results) == len(stream) and all(r is not None for r in run.results),
              "the upgrade lost a request")
        for (enc, q), (v, i) in zip(meta, run.results):
            check(any(torch.equal(v, av) and torch.equal(i, ai)
                      for av, ai in (search_v1(enc(q)), search_v2(enc(q)))),
                  "an upgrade result is none its version's (encoder, index) pairs give")
        st = run.stats
        finals = [r["embedding_version"] for r in st["per_replica"]]
        check(st["compat_dispatches"] >= 1, "no compat dispatch during the upgrade")
        check(finals == ["v2"] * UPGRADE_REPLICAS, f"replicas ended on {finals}")
        check(run.swap is not None and run.swap.swapped == UPGRADE_REPLICAS, "the swap failed")
        check(upgrade_launches >= len(stream),
              f"the upgrade's requests launched sdc_topk {upgrade_launches} times")
        log(f"[upgrade] v1 -> v2 on {UPGRADE_REPLICAS} replicas sharing the card: BC training "
            f"{TRAIN_STEPS} steps {bc_wall:.2f} s wall; {len(stream)} mixed-version requests of "
            f"{SERVE_Q}, the swap after {UPGRADE_AFTER}: none lost, each the answer of its "
            f"version's encoder on the v1 or v2 index, {st['compat_dispatches']} compat "
            f"dispatches, replicas ended on {finals}, swap {1e3 * run.swap.total_s:.0f} ms, "
            f"{upgrade_launches} sdc_topk launches (requests, warm-ups and canaries)")
        log(f"[upgrade] recall@{K} over {TRAIN_QUERIES} queries on the v1 index: v2 queries "
            f"through the BC-trained binarizer {bc_recall:.4f} (the reference {REF_BC_RECALL}, "
            f"held to within {RECALL_MARGIN}), through the v1 binarizer {warm_recall:.4f}; "
            f"COMPAT_RECALL_FLOOR {lifecycle.COMPAT_RECALL_FLOOR} is held at the reference "
            f"test's width in (c)")

        # -- (e) times -------------------------------------------------------------
        def stepper(step_fn, st, *extra):
            holder = [st]

            def fn():
                holder[0] = step_fn(holder[0], *extra, cfg)[0]
            return fn

        ta, tp = next(gen)
        fresh = T.init_train_state(cfg, torch.Generator(device=device).manual_seed(seed), device)
        bc_state = fresh._replace(model=copy.deepcopy(first.model),
                                  m_model=copy.deepcopy(first.model))
        for tag, fn in (("train_step", stepper(T.train_step, state, ta, tp)),
                        ("bc_train_step", stepper(lambda s, a_, p_, c: T.bc_train_step(
                            s, first.model, a_, p_, c), bc_state, ta, tp))):
            ms = host_ms(fn, TIME_STEPS)
            calls, kernels_run = launches_per_call(fn)
            busy = device_busy_ms(fn, 5)
            share = busy / ms if isinstance(busy, float) else "not measured"
            log(f"[time] {tag} on {name} ({smi}): {ms:.3f} ms a step (host clock, synced, "
                f"{TIME_STEPS} steps), {calls} launch calls and {kernels_run} device kernels a "
                f"step, device busy {busy if isinstance(busy, str) else f'{busy:.3f} ms'} "
                f"({share if isinstance(share, str) else f'{100 * share:.1f}%'} of the step)")
        log(f"[time] training wall: {TRAIN_STEPS} steps {wall0:.2f} / {wall1:.2f} s "
            f"({1e3 * wall0 / TRAIN_STEPS:.2f} ms a step with the numpy pairs and their upload), "
            f"BC {bc_wall:.2f} s on {name} ({smi})")

        # the scan at this path's shape, for the kernels line
        index = FlatSDC.build(snaps["v1"].codes, LEVELS, device=device)
        q = enc_v1(batches[0])
        args_k = dict(n_levels=LEVELS, k=K, packed=False)
        v, i = topk(q, index.codes, index.inv_norm, **args_k)
        pv, pi = sdc_mod.sdc_topk_torch(q, index.codes, index.inv_norm, **args_k)
        check(torch.equal(v, pv) and torch.equal(i, pi), "sdc_topk differs from its plain version")
        ms = cuda_ms(lambda: topk(q, index.codes, index.inv_norm, **args_k), 20)
        plain_ms = cuda_ms(lambda: sdc_mod.sdc_topk_torch(q, index.codes, index.inv_norm,
                                                          **args_k), 5)
        n = index.codes.shape[0]
        nbytes = n * (CODE_DIM + 4) + q.numel() + SERVE_Q * K * 8
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * 2 * SERVE_Q * n * CODE_DIM / INT8_OPS_PER_S
        n8 = n - n % 8
        sq = q.to(torch.int32).sum(-1, keepdim=True)
        sd = index.codes[:n8].to(torch.int32).sum(-1)[None, :]

        def library():
            dot = torch._int_mm(q, index.codes[:n8].t())
            s = B.sdc_affine_epilogue(dot, sq + sd, dim=CODE_DIM, n_levels=LEVELS,
                                      inv_norm=index.inv_norm[:n8][None, :])
            return torch.topk(s, K)

        library_ms = cuda_ms(library, 5)
        log(f"[time] sdc_topk int8 Q={SERVE_Q} N={n} D={CODE_DIM} k={K} (the trained codes) on "
            f"{name} ({smi}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, HBM bound "
            f"{bytes_ms:.5f} ms, int8 op bound {ops_ms:.5f} ms, library {library_ms:.4f} ms")
        log(f"[train] phase passed in {time.perf_counter() - t_phase:.1f} s")
        return dict(name="sdc_topk_int8_trained", route="cuda", source=SOURCE,
                    replaces=REPLACES[False], launches=upgrade_launches,
                    max_abs_err=float((v - pv).abs().max()), ms=ms, plain_ms=plain_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=library_ms)
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def _paper_claims(seed, device):
    """The reference tests' claims on the card, at their widths, recall over
    1,024 queries of their corpora: ``tests/test_system.py`` (ours >= the
    1-bit hash, ours >= 0.85 x float) and ``tests/test_compat.py`` (the
    Table 4 ordering, and COMPAT_RECALL_FLOOR through the v1 flat index).
    Returns their lines."""
    import numpy as np
    import torch

    from repro_torch.core import binarize_lib as B
    from repro_torch.core import losses as L
    from repro_torch.core import trainer as T
    from repro_torch.data import synthetic as S
    from repro_torch.index.flat import FlatFloat, FlatSDC
    from repro_torch.launch import lifecycle
    from repro_torch.launch.serve import bc_train_binarizer, recall_at_k
    from repro_torch.train import optim

    def train(cfg, docs, steps, s, batch):
        st = T.init_train_state(cfg, torch.Generator(device=device).manual_seed(s), device)
        gen = S.pair_batches(docs, s + 1, batch, device=device)
        for _ in range(steps):
            st, _ = T.train_step(st, *next(gen), cfg)
        return st.model

    dim, code = 64, 32
    docs, queries, gt = S.clustered_corpus(seed, 4000, 1024, dim, n_clusters=128)
    r = {"float": recall_at_k(FlatFloat.build(docs, device=device).search(queries, K)[1], gt)}
    for tag, levels, s in (("ours", 4, seed), ("hash", 1, seed + 3)):
        cfg = T.TrainConfig(
            binarizer=B.BinarizerConfig(input_dim=dim, code_dim=code, n_levels=levels,
                                        hidden_dim=128),
            queue=L.QueueConfig(length=1024, dim=code, top_k=32),
            adam=optim.AdamConfig(lr=2e-3, clip_norm=5.0, schedule=optim.cosine_schedule(
                300, warmup=30, floor=0.05)))
        model = train(cfg, docs, 300, s, 128)
        enc = B.make_encode_fn(model)
        index = FlatSDC.build(enc(docs), levels, device=device)
        r[tag] = recall_at_k(index.search(enc(queries), K)[1], gt)
    check(r["ours"] >= r["hash"] and r["ours"] >= 0.85 * r["float"],
          f"test_system's claims fail on the card: {r}")
    system = (f"test_system: ours {r['ours']:.4f} >= hash {r['hash']:.4f}, >= 0.85 x float "
              f"{r['float']:.4f}")

    cfg = T.TrainConfig(
        binarizer=B.BinarizerConfig(input_dim=dim, code_dim=code, n_levels=3, hidden_dim=48),
        queue=L.QueueConfig(length=512, dim=code, top_k=16),
        adam=optim.AdamConfig(lr=1e-3, clip_norm=5.0),
        temperature=0.2, bc_weight=1.0, bc_influence_weight=4.0)
    docs, queries, gt = S.clustered_corpus(seed, 3000, 1024, dim, n_clusters=128)
    new_docs, new_queries = S.backbone_upgrade(docs, 5), S.backbone_upgrade(queries, 5)
    old = train(cfg, docs, 150, seed, 64)
    bc = bc_train_binarizer(old, docs, new_docs, cfg, steps=300, batch=128, device=device).model
    free = train(cfg, new_docs, 150, 99, 64)

    def cross(qm, dm, q_emb, d_emb):
        bq = B.binarize_eval(qm, torch.as_tensor(np.asarray(q_emb, np.float32), device=device))
        bd = B.binarize_eval(dm, torch.as_tensor(np.asarray(d_emb, np.float32), device=device))
        idx = torch.sort(L.cosine(bq, bd), dim=1, descending=True, stable=True).indices[:, :K]
        return recall_at_k(idx, gt)

    c = {"baseline": cross(old, old, queries, docs), "incompatible": cross(free, old, new_queries,
                                                                           docs),
         "warm_only": cross(old, old, new_queries, docs), "compatible": cross(bc, old, new_queries,
                                                                              docs)}
    snap = lifecycle.CorpusSnapshot(codes=B.make_encode_fn(old)(docs).cpu().numpy(), n_levels=3,
                                    embedding_version="v1")
    search = lifecycle.make_builder("flat", k=K, device=device).build(snap)
    c["v1_index"] = recall_at_k(search(B.make_encode_fn(bc)(new_queries))[1], gt)
    check(c["baseline"] > 0.8 and c["incompatible"] < 0.2
          and c["compatible"] > c["warm_only"] + 0.05
          and c["compatible"] > c["incompatible"] + 0.3
          and c["compatible"] >= c["baseline"] - 0.2
          and c["v1_index"] >= lifecycle.COMPAT_RECALL_FLOOR,
          f"test_compat's claims fail on the card: {c}")
    compat = ("test_compat: " + ", ".join(f"{k} {v:.4f}" for k, v in c.items())
              + f" (floor {lifecycle.COMPAT_RECALL_FLOOR})")
    return {"system": system, "compat": compat}


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
    step, params = dlrm_serve_step(CONFIG), model.tree()
    batches = {shape: [dlrm_batch(s, B, CONFIG, device) for s in range(DLRM_BATCHES)]
               for shape, B in DLRM_SHAPES}
    for shape, bs in batches.items():
        step(params, bs[0])  # warm up
    torch.cuda.synchronize()
    di_mod.dot_interact.launches = 0
    logits, step_ms = {}, {}
    for shape, bs in batches.items():
        t0 = time.perf_counter()
        logits[shape] = [step(params, b) for b in bs]
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


def _zoo_leaf_err(k, got, want):
    """|card - CPU| of moment leaf ``k`` over its largest CPU entry; DIEN's
    last attention bias (its gradient is rounding noise:
    ``dien.SHIFT_INVARIANT_LEAVES``) over its weight's, after checking
    that it is noise."""
    from repro_torch.models.recsys.dien import SHIFT_INVARIANT_LEAVES as noise

    ref = want[noise.get(k, k)].double()
    scale = max(float(ref.abs().max()), 1e-30)
    if k in noise:
        check(float(want[k].abs().max()) <= ZOO_GRAD_TOL * scale, f"{k}: not rounding noise")
    return float((got[k].cpu().double() - want[k].double()).abs().max()) / scale


def _zoo_smoke_step(arch, device):
    """One SMOKE train step on the card against the same step on the CPU,
    from the same weights and batch. Returns (loss, gradient norm, worst
    moment) relative differences."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train as train_mod
    from repro_torch.models.recsys.embedding import tree_map
    from repro_torch.train import steps

    cfg = get_arch(arch).smoke_config
    init, builder, batch_of = train_mod.zoo(arch)
    host = init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = batch_of(7, ZOO_BATCH, cfg, "cpu")
    out = []
    for dev in ("cpu", device):
        params = tree_map(lambda t: t.detach().clone().to(dev), host)
        b = {k: v.to(dev) for k, v in batch.items()}
        out.append(builder(cfg, train_mod.ADAM)(params, steps.init_opt_state(params), b)[1:])
    (h_opt, h_m), (c_opt, c_m) = out
    loss = abs(float(c_m["loss"]) - float(h_m["loss"])) / abs(float(h_m["loss"]))
    norm = abs(float(c_m["grad_norm"]) - float(h_m["grad_norm"])) / float(h_m["grad_norm"])
    worst = max(_zoo_leaf_err(k, getattr(c_opt, f), getattr(h_opt, f))
                for f in ("mu", "nu") for k in h_opt.mu)
    return loss, norm, worst


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


class _SdcTopkCalls:
    """While active, every ``sdc_topk`` call made through the port's call
    sites (``kernels.sdc.ops`` for the indexes, ``train.steps`` for the
    BEBR step) is recorded: its inputs and outputs, held against the plain
    version afterwards (``check``). Recording adds no launch."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels.sdc import ops as sdc_ops
        from repro_torch.kernels.sdc import sdc as sdc_mod
        from repro_torch.train import steps

        kernel, calls = sdc_mod.sdc_topk, self.calls

        def recorded(q, d, inv, **kw):
            out = kernel(q, d, inv, **kw)
            calls.append((q.clone(), d, inv, kw, out))
            return out

        self.sites = [(m, m.sdc_topk) for m in (sdc_ops, steps)]
        for m, _ in self.sites:
            m.sdc_topk = recorded
        return self

    def __exit__(self, *exc):
        for m, fn in self.sites:
            m.sdc_topk = fn

    def check(self, tag: str, launches: int) -> str:
        """Every recorded call's scores and ids exactly its plain version's
        on the same card tensors, and one recorded call for each of the
        ``launches`` counted; returns the shapes held, for the log."""
        import torch

        from repro_torch.kernels.sdc import sdc as sdc_mod

        check(len(self.calls) == launches and launches >= 1,
              f"{tag}: {len(self.calls)} sdc_topk calls recorded, {launches} launches")
        shapes = {}
        for q, d, inv, kw, (v, i) in self.calls:
            plain = dict(n_levels=kw["n_levels"], k=kw["k"], packed=kw.get("packed", False))
            pv, pi = sdc_mod.sdc_topk_torch(q, d, inv, **plain)
            shape = f"[{q.shape[0]}, {d.shape[0]}] D {q.shape[1]} k {kw['k']}"
            check(torch.equal(v, pv) and torch.equal(i, pi),
                  f"{tag}: sdc_topk at {shape} differs from its plain version")
            shapes[shape] = shapes.get(shape, 0) + 1
        self.calls.clear()
        return ", ".join(f"{n} at {sh}" for sh, n in shapes.items())


def _check_trained(tag: str, training: dict) -> str:
    """Each model an example trained moved from its initial weights and
    its loss fell (a binarizer's on held-out pairs, initial against
    trained weights: its training loss rises as the queue fills; the
    two-tower's over the run); returns the figures."""
    out = []
    for model, p in training.items():
        check(p["moved"], f"{tag}: training left {model}'s initial weights unchanged")
        check(p["loss_after"] < p["loss_before"],
              f"{tag}: {model}'s loss ({p['loss']}) went from {p['loss_before']:.4f} to "
              f"{p['loss_after']:.4f}")
        out.append(f"{model} loss {p['loss_before']:.4f} -> {p['loss_after']:.4f} ({p['loss']})")
    return ", ".join(out)


def _load_example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def zoo_phase(device, name, smi):
    """Phase 11: the recsys zoo trained and served at full width through
    the port's launcher, SMOKE card steps against the CPU's, then the
    three examples. Returns the kernels' JSON rows (dot_interact in
    training, sdc_topk at the two-tower example's shape)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels.dot_interact import kernel as di_mod
    from repro_torch.kernels.dot_interact import ops as di_ops
    from repro_torch.kernels.dot_interact.ref import dot_interact_torch, tril_indices
    from repro_torch.kernels.sdc import ref as sdc_ref
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import steps

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(ROOT, "build"))
    rows = []
    try:
        # -- (a) the four archs at full width through the launcher ---------------
        for arch in ZOO_ARCHS:
            t_arch = time.perf_counter()
            cfg = get_arch(arch).config
            ckpt = os.path.join(root, arch)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = ["--arch", arch, "--full", "--batch", str(ZOO_BATCH), "--device", str(device)]
            # the unbroken run: 20 steps in one process, nothing written
            torch.cuda.synchronize()
            di_mod.dot_interact.launches = 0
            t0 = time.perf_counter()
            whole, text = _quiet(train_mod.main, base + ["--steps", str(ZOO_STEPS)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = di_mod.dot_interact.launches
            check(launches == (ZOO_STEPS if arch == "dlrm-rm2" else 0),
                  f"{arch}: {ZOO_STEPS} steps launched dot_interact {launches} times")
            check(text.rstrip().endswith("done."), f"{arch}: the launcher said {text}")
            losses = whole["losses"]
            check(sorted(losses) == list(range(1, ZOO_STEPS + 1))
                  and all(bool(torch.isfinite(v)) for v in losses.values()),
                  f"{arch}: losses missing or not finite")
            params_a = ckpt_lib.flatten_tree(whole["params"])
            del whole
            # the broken run: a checkpoint every 10 steps, ended after step 10
            t0 = time.perf_counter()
            first, text1 = _quiet(train_mod.main, base + [
                "--steps", str(ZOO_CKPT_EVERY), "--ckpt-dir", ckpt,
                "--ckpt-every", str(ZOO_CKPT_EVERY)])
            torch.cuda.synchronize()
            wall1 = time.perf_counter() - t0
            check(f"[ckpt] step {ZOO_CKPT_EVERY}" in text1
                  and ckpt_lib.latest_step(ckpt) == ZOO_CKPT_EVERY,
                  f"{arch}: the launcher said {text1}")
            check(all(torch.equal(first["losses"][i], losses[i])
                      for i in range(1, ZOO_CKPT_EVERY + 1)),
                  f"{arch}: the first {ZOO_CKPT_EVERY} losses differ between two runs")
            del first
            step_dir = os.path.join(ckpt, f"step_{ZOO_CKPT_EVERY:010d}")
            ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
            # resumed to step 20, writing no checkpoint (one at step 20 would go unread)
            t0 = time.perf_counter()
            resumed, text2 = _quiet(train_mod.main, base + [
                "--steps", str(ZOO_STEPS), "--ckpt-dir", ckpt, "--ckpt-every",
                str(ZOO_STEPS + 1), "--resume"])
            torch.cuda.synchronize()
            wall2 = time.perf_counter() - t0
            check(f"[resume] from step {ZOO_CKPT_EVERY}" in text2 and "[ckpt]" not in text2,
                  f"{arch}: the resumed launcher said {text2}")
            tail = list(range(ZOO_CKPT_EVERY + 1, ZOO_STEPS + 1))
            check(sorted(resumed["losses"]) == tail
                  and all(torch.equal(resumed["losses"][i], losses[i]) for i in tail),
                  f"{arch}: the resumed losses differ from the unbroken run's")
            params_b = ckpt_lib.flatten_tree(resumed["params"])
            check(list(params_a) == list(params_b)
                  and all(torch.equal(params_a[k], params_b[k]) for k in params_a),
                  f"{arch}: the resumed parameters differ from the unbroken run's")
            del params_a, params_b
            shutil.rmtree(ckpt)
            log(f"[zoo] {arch} --full, {ZOO_STEPS} steps of {ZOO_BATCH}: unbroken {wall:.1f} s "
                f"wall, losses {float(losses[1]):.4f} -> {float(losses[ZOO_STEPS]):.4f}; "
                f"{ZOO_CKPT_EVERY} steps and a checkpoint ({ck_bytes / 1e9:.2f} GB) "
                f"{wall1:.1f} s, resumed from it to step {ZOO_STEPS} "
                f"{wall2:.1f} s, bit-identical to the unbroken run (its {len(tail)} losses and "
                f"every parameter)")

            # times, with the resumed state (it trains on)
            params, opt = resumed["params"], resumed["opt_state"]
            del resumed
            _, builder, batch_of = train_mod.zoo(arch)
            step = builder(cfg, train_mod.ADAM)
            batch = batch_of(ZOO_STEPS, ZOO_BATCH, cfg, device)
            state = [params, opt]

            def fn():
                state[0], state[1], _ = step(state[0], state[1], batch)

            ms = host_ms(fn, ZOO_TIME_STEPS)
            calls, kernels_run = launches_per_call(fn, 2)
            busy = device_busy_ms(fn, 2)
            share = busy / ms if isinstance(busy, float) else "not measured"
            leaves = ckpt_lib.flatten_tree(params)
            nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
            log(f"[time] zoo {arch} train step B={ZOO_BATCH} on {name} ({smi}): "
                f"{cfg.param_count()} parameters ({nbytes / 1e9:.2f} GB), {ms:.3f} ms a step "
                f"(host clock, synced, {ZOO_TIME_STEPS} steps), {calls} launch calls and "
                f"{kernels_run} device kernels a step, device busy "
                f"{busy if isinstance(busy, str) else f'{busy:.3f} ms'} "
                f"({share if isinstance(share, str) else f'{100 * share:.1f}%'} of the step), "
                f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

            # one serving batch through the arch's serve step
            with torch.no_grad():
                if arch == "dlrm-rm2":
                    serve_b = synthetic.dlrm_batch(0, 512, cfg, device)
                    out = steps.dlrm_serve_step(cfg)(params, serve_b)
                    want = (512,)
                elif arch == "two-tower-retrieval":
                    serve_b = dict(batch, cand_ids=torch.randint(
                        0, cfg.item_vocab, (4096,), device=device))
                    out = steps.tt_serve_step(cfg)(params, serve_b)
                    want = (ZOO_BATCH, 4096)
                elif arch == "mind":
                    out = steps.mind_serve_step(cfg)(params, batch)
                    want = (ZOO_BATCH, cfg.n_interests, cfg.embed_dim)
                else:
                    out = steps.dien_serve_step(cfg)(params, batch)
                    want = (ZOO_BATCH,)
            check(tuple(out.shape) == want and bool(torch.isfinite(out).all()),
                  f"{arch}: the serve step gave {tuple(out.shape)} or non-finite values")
            msg = f"[zoo] {arch} serve step: {tuple(out.shape)} finite"

            if arch == "two-tower-retrieval":
                # the BEBR retrieval step: the tower, the linear binarizer, sdc_topk
                g = torch.Generator(device=device).manual_seed(1)
                emb, code, levels = cfg.tower_mlp[-1], 64, 4
                params["binarizer"] = {
                    "W": [torch.randn((emb, code), generator=g, device=device) / emb**0.5
                          for _ in range(levels)],
                    "R": [torch.randn((code, emb), generator=g, device=device) / code**0.5
                          for _ in range(levels - 1)]}
                codes = torch.randint(0, 2**levels, (ZOO_BEBR_DOCS, code), generator=g,
                                      device=device).to(torch.int8)
                bebr_b = {"hist_ids": batch["hist_ids"][:1], "hist_mask": batch["hist_mask"][:1],
                          "cand_codes": codes, "cand_inv": sdc_ref.doc_inv_norms(codes, levels)}
                sdc_mod.sdc_topk.launches = 0
                with _SdcTopkCalls() as seen:
                    v, i = steps.tt_retrieval_bebr_step(cfg, k=100, code_dim=code)(params,
                                                                                  bebr_b)
                torch.cuda.synchronize()
                check(v.shape == (1, 100) and bool(((i >= 0) & (i < ZOO_BEBR_DOCS)).all())
                      and bool((v[:, :-1] >= v[:, 1:]).all()),
                      "tt_retrieval_bebr_step on the card")
                held = seen.check("tt_retrieval_bebr_step", sdc_mod.sdc_topk.launches)
                msg += (f"; tt_retrieval_bebr_step over {ZOO_BEBR_DOCS} codes: "
                        f"{sdc_mod.sdc_topk.launches} sdc_topk launch ({held}), exactly its "
                        "plain version's scores and ids")
                del params["binarizer"], codes, bebr_b, seen

            if arch == "dlrm-rm2":
                # the kernel's output inside one training step against the plain version
                seen, kernel = [], di_ops.dot_interact

                def recorded(e):
                    out = kernel(e)
                    seen.append((e.detach().clone(), out.detach().clone()))
                    return out

                di_ops.dot_interact = recorded
                try:
                    fn()
                finally:
                    di_ops.dot_interact = kernel
                torch.cuda.synchronize()
                check(len(seen) == 1, f"one dlrm step ran the interaction {len(seen)} times")
                emb, inter = seen[0]
                plain = dot_interact_torch(emb)
                check(torch.equal(inter, plain),
                      "dot_interact inside a training step differs from its plain version")
                err = float((inter - plain).abs().max())
                B, F, D = emb.shape
                P = F * (F - 1) // 2
                rows_i, cols_i = tril_indices(F, device)
                grad = torch.randn((B, P), generator=torch.Generator(device=device).manual_seed(2),
                                   device=device)
                ms_f = cuda_ms(lambda: di_mod.dot_interact(emb), 200)
                plain_ms = cuda_ms(lambda: dot_interact_torch(emb), 20)
                library_ms = cuda_ms(lambda: torch.bmm(emb, emb.transpose(1, 2))[:, rows_i, cols_i],
                                     200)
                ms_b = cuda_ms(lambda: di_ops.dot_interact_backward(emb, grad), 200)
                nbytes_f = (B * F * D + B * P) * 4
                bytes_ms, ops_ms = 1e3 * nbytes_f / HBM_BYTES_PER_S, 1e3 * 2 * B * P * D / FP32_FLOPS_PER_S
                nbytes_b = (2 * B * F * D + B * P) * 4
                bwd_bytes_ms = 1e3 * nbytes_b / HBM_BYTES_PER_S
                bwd_ops_ms = 1e3 * 2 * B * F * F * D / FP32_FLOPS_PER_S
                rows.append(dict(
                    name="dot_interact_train", route="cuda", source=DOT_INTERACT_SOURCE,
                    replaces=DOT_INTERACT_REPLACES, launches=launches, max_abs_err=err, ms=ms_f,
                    plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=library_ms, backward_ms=ms_b))
                msg += (f"; dot_interact inside a training step exactly equal to its plain "
                        f"version at [{B}, {F}, {D}]")
                log(f"[time] dot_interact in training B={B} F={F} D={D} on {name} ({smi}): "
                    f"forward kernel {ms_f:.4f} ms, plain {plain_ms:.3f} ms, bound "
                    f"{max(bytes_ms, ops_ms):.5f} ms, library (torch.bmm + triangle) "
                    f"{library_ms:.4f} ms; backward (plain torch: S + S^T, one torch.bmm) "
                    f"{ms_b:.4f} ms, its bound {max(bwd_bytes_ms, bwd_ops_ms):.5f} ms; "
                    f"{launches} kernel launches in the {ZOO_STEPS}-step run")
            log(msg)
            del params, opt, state, leaves, batch, out
            torch.cuda.empty_cache()

        # -- SMOKE: one card step per arch against the CPU's ---------------------
        for arch in ZOO_ARCHS:
            loss, norm, worst = _zoo_smoke_step(arch, device)
            check(loss <= ZOO_LOSS_TOL and norm <= ZOO_LOSS_TOL and worst <= ZOO_GRAD_TOL,
                  f"{arch} SMOKE card step: loss {loss:.2e}, norm {norm:.2e}, moments "
                  f"{worst:.2e} from the CPU's")
            log(f"[zoo] {arch} SMOKE: one train step on the card against the CPU's from the same "
                f"weights and batch: loss {loss:.2e}, gradient norm {norm:.2e} (tolerance "
                f"{ZOO_LOSS_TOL}), Adam's moments {worst:.2e} of each leaf's largest entry "
                f"(tolerance {ZOO_GRAD_TOL})")

        # -- (b) the three examples at their defaults -----------------------------------
        figures, walls, held, trained = {}, {}, {}, {}
        dev_arg = ["--device", str(device)]
        for example, argv in (
                ("train_two_tower_e2e_torch", ["--ckpt", os.path.join(root, "e2e")]),
                ("quickstart_torch", []), ("compat_upgrade_torch", [])):
            sdc_mod.sdc_topk.launches = 0
            t0 = time.perf_counter()
            with _SdcTopkCalls() as seen:
                out = _load_example(example).main(argv + dev_arg)
            torch.cuda.synchronize()
            walls[example] = time.perf_counter() - t0
            launches_ex = sdc_mod.sdc_topk.launches
            held[example] = seen.check(example, launches_ex)
            trained[example] = _check_trained(example, out["training"])
            if example.startswith("train_two_tower"):
                check(launches_ex == 1,
                      f"the two-tower example launched sdc_topk {launches_ex} times")
                e2e, e2e_launches = out, launches_ex
                figures.update(tt_group_float=out["group_float"], tt_group_bebr=out["group_bebr"],
                               tt_cover=out["cover"])
            elif example.startswith("quickstart"):
                figures.update(qs_recall_float=out["recall_float"],
                               qs_recall_bebr=out["recall_bebr"])
            else:
                check(out["finals"] == ["v2", "v2"] and out["lost"] == 0
                      and out["compat_dispatches"] >= 1,
                      f"the compat example's migration: {out}")
                figures.update(bc_old_old=out["old_old"], bc_naive=out["naive"],
                               bc_compat=out["compat"], bc_mixed_v1=out["mixed_v1"],
                               bc_mixed_v2=out["mixed_v2"])
            del out, seen
        for fig, got in figures.items():
            default, lo, hi = REF_ZOO_FIGURES[fig]
            check(lo - FIGURE_MARGIN <= got <= hi + FIGURE_MARGIN,
                  f"{fig} = {got:.4f} is not within {FIGURE_MARGIN} of the reference's "
                  f"[{lo}, {hi}] over {REF_ZOO_KEYS} keys")
        for example in walls:
            log(f"[zoo] {example} on the card: {walls[example]:.1f} s; sdc_topk calls held "
                f"exactly against the plain version: {held[example]}; trained: "
                f"{trained[example]} (each model's weights moved)")
        log("[zoo] example figures (port on the card | reference key 0, [min, max] over "
            f"{REF_ZOO_KEYS} keys; held within {FIGURE_MARGIN} of that range): "
            + ", ".join(f"{k} {v:.4f} | {REF_ZOO_FIGURES[k][0]} [{REF_ZOO_FIGURES[k][1]}, "
                        f"{REF_ZOO_FIGURES[k][2]}]" for k, v in figures.items()))

        # the scan at the example's shape, for the kernels line
        index, q = e2e["index"], e2e["q_codes"]
        args_k = dict(n_levels=index.n_levels, k=100, packed=False)
        v, i = sdc_mod.sdc_topk(q, index.codes, index.inv_norm, **args_k)
        pv, pi = sdc_mod.sdc_topk_torch(q, index.codes, index.inv_norm, **args_k)
        check(torch.equal(v, pv) and torch.equal(i, pi),
              "sdc_topk at the example's shape differs from its plain version")
        ms = cuda_ms(lambda: sdc_mod.sdc_topk(q, index.codes, index.inv_norm, **args_k), 50)
        plain_ms = cuda_ms(lambda: sdc_mod.sdc_topk_torch(q, index.codes, index.inv_norm,
                                                          **args_k), 10)
        n, d = index.codes.shape
        Q = q.shape[0]
        nbytes = n * (d + 4) + q.numel() + Q * 100 * 8
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * 2 * Q * n * d / INT8_OPS_PER_S
        sq = q.to(torch.int32).sum(-1, keepdim=True)
        sd = index.codes.to(torch.int32).sum(-1)[None, :]

        def library():
            from repro_torch.core.binarize_lib import sdc_affine_epilogue
            dot = torch._int_mm(q, index.codes.t())
            s = sdc_affine_epilogue(dot, sq + sd, dim=d, n_levels=index.n_levels,
                                    inv_norm=index.inv_norm[None, :])
            return torch.topk(s, 100)

        library_ms = cuda_ms(library, 50)
        log(f"[time] sdc_topk int8 Q={Q} N={n} D={d} k=100 (the two-tower example's catalog) "
            f"on {name} ({smi}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, HBM bound "
            f"{bytes_ms:.5f} ms, int8 op bound {ops_ms:.5f} ms, library {library_ms:.4f} ms")
        rows.append(dict(name="sdc_topk_int8_example", route="cuda", source=SOURCE,
                         replaces=REPLACES[False], launches=e2e_launches,
                         max_abs_err=float((v - pv).abs().max()), ms=ms, plain_ms=plain_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                         library_ms=library_ms))
        log(f"[zoo] phase passed in {time.perf_counter() - t_phase:.1f} s")
        return rows
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _profiled(fn):
    """(host ms, device-busy ms or "not measured") of one call of ``fn``
    under torch.profiler, after a warm-up call; for calls of seconds,
    where a second warm-up would cost more than it tells."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    us = sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
             for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA)
    return ms, (us / 1e3 if us else "not measured")


def _busy(ms, busy) -> str:
    if isinstance(busy, str):
        return busy
    return f"{busy:.1f} ms ({100 * busy / ms:.1f}% of the call)"


def _row_rel(got, want) -> float:
    """max over rows of |got - want| / the row's largest |want| (float32)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)).max())


def _equal_trees(a, b) -> bool:
    """Two parameter trees (or moment dictionaries) equal bit for bit."""
    import torch

    from repro_torch.train import checkpoint as ckpt_lib

    a, b = ckpt_lib.flatten_tree(a), ckpt_lib.flatten_tree(b)
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def lm_gnn_phase(device, name, smi):
    """Phase 12: the LM family (llama3.2-1b at full width through the
    launcher, a repeated batch, prefill and decode at 32,768 tokens with a
    bfloat16 and an int8 cache, llama4-scout's MoE at full width and two
    layers, the five full configs on the meta device) and meshgraphnet
    (through the launcher, and twice at minibatch_lg's size, bit-identical),
    with one SMOKE card step each against the CPU's. Adds no kernel."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import train as train_mod
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import steps

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_lm_", dir=os.path.join(ROOT, "build"))
    try:
        # -- (a) llama3.2-1b --full through the launcher, and one resume ----------
        cfg = get_arch(LM_ARCH).config
        tokens_a_step = ZOO_BATCH * train_mod.LM_SEQ
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = ["--arch", LM_ARCH, "--full", "--batch", str(ZOO_BATCH), "--device", str(device)]
        t0 = time.perf_counter()
        whole, text = _quiet(train_mod.main, base + ["--steps", str(LM_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses, lnorms = whole["losses"], whole["grad_norms"]
        check(text.rstrip().endswith("done.") and sorted(losses) == list(range(1, LM_STEPS + 1))
              and all(bool(torch.isfinite(v)) for v in (*losses.values(), *lnorms.values())),
              f"{LM_ARCH}: the launcher said {text} (gradient norms {lnorms})")
        params_a = ckpt_lib.flatten_tree(whole["params"])
        del whole
        start, _, _ = train_mod._build(LM_ARCH, False, ZOO_BATCH, device)
        start = ckpt_lib.flatten_tree(start)
        # the norm scales start at 1.0, where an Adam step of lr 3e-4 is below
        # half of bf16's spacing (2^-8): they stay, in the reference too
        unmoved = [k for k in start if torch.equal(start[k], params_a[k])]
        check(all("norm" in k for k in unmoved) and len(unmoved) < len(start),
              f"{LM_ARCH}: {LM_STEPS} steps left {unmoved} at their initial values")
        del start
        ckpt = os.path.join(root, LM_ARCH)
        t0 = time.perf_counter()
        first, text1 = _quiet(train_mod.main, base + [
            "--steps", str(LM_RESUME_AT), "--ckpt-dir", ckpt, "--ckpt-every", str(LM_RESUME_AT)])
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        check(f"[ckpt] step {LM_RESUME_AT}" in text1 and all(
            torch.equal(first["losses"][i], losses[i]) for i in range(1, LM_RESUME_AT + 1)),
            f"{LM_ARCH}: the checkpointed run differs from the unbroken one: {text1}")
        del first
        step_dir = os.path.join(ckpt, f"step_{LM_RESUME_AT:010d}")
        ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        t0 = time.perf_counter()
        resumed, text2 = _quiet(train_mod.main, base + [
            "--steps", str(LM_STEPS), "--ckpt-dir", ckpt, "--ckpt-every", str(LM_STEPS + 1),
            "--resume"])
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        tail = list(range(LM_RESUME_AT + 1, LM_STEPS + 1))
        check(f"[resume] from step {LM_RESUME_AT}" in text2
              and sorted(resumed["losses"]) == tail
              and all(torch.equal(resumed["losses"][i], losses[i]) for i in tail),
              f"{LM_ARCH}: the resumed losses differ from the unbroken run's: {text2}")
        params_b = ckpt_lib.flatten_tree(resumed["params"])
        check(all(torch.equal(params_a[k], params_b[k]) for k in params_a),
              f"{LM_ARCH}: the resumed parameters differ from the unbroken run's")
        del params_a, params_b
        shutil.rmtree(ckpt)
        log(f"[lm] {LM_ARCH} --full ({cfg.param_count()} parameters, bf16), {LM_STEPS} steps of "
            f"{ZOO_BATCH} x {train_mod.LM_SEQ} tokens through the launcher: {wall:.1f} s wall, "
            f"losses {', '.join(f'{float(losses[i]):.4f}' for i in sorted(losses))}, gradient "
            f"norms {', '.join(f'{float(lnorms[i]):.3f}' for i in sorted(lnorms))}, every "
            f"weight moved ({len(unmoved)} bf16 norm scales at 1.0 stay); {LM_RESUME_AT} steps and a checkpoint ({ck_bytes / 1e9:.2f} GB) "
            f"{wall1:.1f} s, resumed to step {LM_STEPS} {wall2:.1f} s, bit-identical to the "
            f"unbroken run (losses and every parameter)")

        # -- (b) one repeated batch through the step builder: the loss falls ------
        params, opt = resumed["params"], resumed["opt_state"]
        del resumed
        step = steps.lm_train_step(cfg, train_mod.ADAM)
        batch = synthetic.lm_batch(LM_STEPS, ZOO_BATCH, train_mod.LM_SEQ, cfg.vocab, device)
        fit, norms = [], []
        for _ in range(LM_FIT_STEPS):
            params, opt, m = step(params, opt, batch)
            fit.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        check(all(map(math.isfinite, fit + norms)) and fit[-1] < fit[0],
              f"{LM_ARCH}: a repeated batch's loss went {fit} (gradient norms {norms})")
        state = [params, opt]

        def train_fn():
            state[0], state[1], _ = step(state[0], state[1], batch)

        ms = host_ms(train_fn, LM_TIME_STEPS)
        calls, kernels_run = launches_per_call(train_fn, 1)
        busy = device_busy_ms(train_fn, 1)
        peak_train = torch.cuda.max_memory_allocated() / 1e9
        params = state[0]
        del state, opt, step, batch
        torch.cuda.empty_cache()
        log(f"[lm] {LM_ARCH}: one repeated batch through lm_train_step, {LM_FIT_STEPS} steps: "
            f"loss {fit[0]:.4f} -> {fit[-1]:.4f}, gradient norms {norms[0]:.3f} -> "
            f"{norms[-1]:.3f} (finite)")
        log(f"[time] lm {LM_ARCH} train step B={ZOO_BATCH} S={train_mod.LM_SEQ} on {name} ({smi}): "
            f"{ms:.2f} ms a step (host clock, synced, {LM_TIME_STEPS} steps), "
            f"{tokens_a_step / ms * 1e3:.0f} tokens/s, {calls} launch calls and {kernels_run} "
            f"device kernels a step, device busy {_busy(ms, busy)}, peak memory "
            f"{peak_train:.1f} GB")

        # -- (c) prefill == forward's last position, the chunked attention --------
        prefill = steps.lm_prefill_step(cfg)
        toks = synthetic.lm_batch(0, 1, LM_CHUNKED_S, cfg.vocab, device)["tokens"]
        with torch.no_grad():
            full, _ = tf.forward(params, toks, cfg)
            last_full = full[:, -1].clone()
            del full
        last = prefill(params, {"tokens": toks})
        err = _row_rel(last, last_full)
        check(last.shape == (1, cfg.vocab) and bool(torch.isfinite(last.float()).all())
              and err <= LM_PREFILL_TOL,
              f"{LM_ARCH}: prefill at S={LM_CHUNKED_S} is {err:.2e} from forward's last position")
        log(f"[lm] {LM_ARCH}: lm_prefill_step at S={LM_CHUNKED_S} (chunked attention, chunk "
            f"{cfg.attn_chunk}) against forward's last position: {err:.2e} of the largest "
            f"|logit| (tolerance {LM_PREFILL_TOL:.2e}, one bf16 rounding)")

        # -- (d) prefill at prefill_32k's length ------------------------------------
        toks = synthetic.lm_batch(1, LM_PREFILL_BATCH, LM_LONG, cfg.vocab, device)["tokens"]
        torch.cuda.reset_peak_memory_stats()
        out = prefill(params, {"tokens": toks})
        check(out.shape == (LM_PREFILL_BATCH, cfg.vocab) and bool(torch.isfinite(out.float()).all()),
              f"{LM_ARCH}: the {LM_LONG}-token prefill gave {tuple(out.shape)} or non-finite logits")
        ms, busy = _profiled(lambda: prefill(params, {"tokens": toks}))
        log(f"[time] lm {LM_ARCH} prefill B={LM_PREFILL_BATCH} S={LM_LONG} (prefill_32k, batch "
            f"cut from 32) on {name} ({smi}): {ms:.1f} ms, "
            f"{LM_PREFILL_BATCH * LM_LONG / ms * 1e3:.0f} tokens/s, device busy {_busy(ms, busy)}, "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; logits finite")
        del toks, out

        # -- (e) decode token by token == forward ---------------------------------
        decode = steps.lm_decode_step(cfg)
        toks = synthetic.lm_batch(2, LM_PROMPT_BATCH, LM_PROMPT, cfg.vocab, device)["tokens"]
        with torch.no_grad():
            full, _ = tf.forward(params, toks, cfg)
        cache = tf.init_kv_cache(cfg, LM_PROMPT_BATCH, LM_PROMPT, device=device)
        dec_err = 0.0
        for t in range(LM_PROMPT):
            lg, cache = decode(params, {"token": toks[:, t]}, cache)
            dec_err = max(dec_err, _row_rel(lg, full[:, t]))
        check(cache["length"] == LM_PROMPT and dec_err <= LM_DECODE_TOL,
              f"{LM_ARCH}: decode is {dec_err:.3e} from forward (tolerance {LM_DECODE_TOL})")
        log(f"[lm] {LM_ARCH}: lm_decode_step token by token over {LM_PROMPT_BATCH} x {LM_PROMPT} "
            f"tokens (bf16 cache) against forward: {dec_err:.3e} of each row's largest |logit| "
            f"(tolerance {LM_DECODE_TOL})")
        del full, cache

        # -- (f) decode at decode_32k's cache length, bf16 and int8 caches ---------
        B, L, KV, hd = LM_DECODE_BATCH, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        filled = LM_LONG - LM_DECODE_STEPS
        torch.cuda.reset_peak_memory_stats()
        c16 = tf.init_kv_cache(cfg, B, LM_LONG, dtype=torch.bfloat16, device=device)
        c8 = tf.init_kv_cache(cfg, B, LM_LONG, dtype=torch.int8, device=device)
        g = torch.Generator(device=device).manual_seed(5)
        for i in range(L):  # the first ``filled`` positions: N(0, 1) keys and values
            for plane in ("k", "v"):
                kv = torch.randn((B, KV, filled, hd), generator=g, device=device,
                                 dtype=torch.bfloat16)
                c16[plane][i, :, :, :filled] = kv
                q8, s8 = tf._quantize_kv(kv)
                c8[plane][i, :, :, :filled] = q8
                c8[f"{plane}_scale"][i, :, :, :filled] = s8
                del kv, q8, s8
        c16["length"] = c8["length"] = filled
        cache_gb = {n: sum(t.numel() * t.element_size() for k, t in c.items() if k != "length")
                    / 1e9 for n, c in (("bf16", c16), ("int8", c8))}
        toks = synthetic.lm_batch(3, B, LM_DECODE_STEPS, cfg.vocab, device)["tokens"]
        caches = {"bf16": c16, "int8": c8}
        del c16, c8
        rel, times, busy = 0.0, {"bf16": [], "int8": []}, {}
        for t in range(LM_DECODE_STEPS):
            out = {}
            for tag in caches:
                def one():
                    out[tag], caches[tag] = decode(params, {"token": toks[:, t]}, caches[tag])

                if t == LM_DECODE_STEPS - 1:  # the last step under the profiler
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        one()
                        torch.cuda.synchronize()
                    us = sum(getattr(ev, "self_device_time_total",
                                     getattr(ev, "self_cuda_time_total", 0))
                             for ev in prof.key_averages()
                             if ev.device_type == torch.autograd.DeviceType.CUDA)
                    busy[tag] = f"{us / 1e3:.2f} ms a step" if us else "not measured"
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                if t > 0:  # step 0 warms up
                    times[tag].append(1e3 * (time.perf_counter() - t0))
            check(all(bool(torch.isfinite(o.float()).all()) for o in out.values()),
                  f"{LM_ARCH}: decode at position {filled + t} gave non-finite logits")
            rel = max(rel, float((out["bf16"].float() - out["int8"].float()).abs().max()
                                 / out["bf16"].float().abs().max()))
        check(all(c["length"] == LM_LONG for c in caches.values()) and rel < LM_INT8_TOL,
              f"{LM_ARCH}: the int8 cache's logits are {rel:.4f} from the bf16 cache's")
        peak_dec = torch.cuda.max_memory_allocated() / 1e9
        del caches, toks, out
        torch.cuda.empty_cache()
        for tag in ("bf16", "int8"):
            ms = sum(times[tag]) / len(times[tag])
            log(f"[time] lm {LM_ARCH} decode B={B} at a {LM_LONG}-token cache (decode_32k, batch "
                f"cut from 128), {tag} cache ({cache_gb[tag]:.2f} GB) on {name} ({smi}): "
                f"{ms:.2f} ms a step (host clock, synced, {len(times[tag])} steps), "
                f"{B / ms * 1e3:.0f} tokens/s, device busy {busy[tag]} (profiled step), peak memory "
                f"{peak_dec:.1f} GB")
        log(f"[lm] {LM_ARCH}: decode at positions {filled}..{LM_LONG - 1} of a {LM_LONG}-token "
            f"cache, batch {B}: int8 cache logits within {rel:.4f} of the bf16 cache's "
            f"(tolerance {LM_INT8_TOL}, the reference's)")
        del params
        torch.cuda.empty_cache()

        # -- (g) llama4-scout's MoE at full width, MOE_LAYERS layers ---------------
        mcfg = dataclasses.replace(get_arch(MOE_ARCH).config, n_layers=MOE_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        mparams = tf.init_params(mcfg, torch.Generator(device=device).manual_seed(0), device)
        mprefill = steps.lm_prefill_step(mcfg)
        toks = synthetic.lm_batch(4, 1, MOE_PREFILL_S, mcfg.vocab, device)["tokens"]
        with torch.no_grad():
            full, aux = tf.forward(mparams, toks, mcfg)
            last_full = full[:, -1].clone()
            del full
        last = mprefill(mparams, {"tokens": toks})
        err = _row_rel(last, last_full)
        check(last.shape == (1, mcfg.vocab) and bool(torch.isfinite(last.float()).all())
              and err <= LM_PREFILL_TOL and math.isfinite(float(aux)),
              f"{MOE_ARCH}: prefill at S={MOE_PREFILL_S} is {err:.2e} from forward")
        ms, busy = _profiled(lambda: mprefill(mparams, {"tokens": toks}))
        log(f"[lm] {MOE_ARCH} at full width cut to {MOE_LAYERS} of {get_arch(MOE_ARCH).config.n_layers} "
            f"layers ({mcfg.param_count()} parameters, bf16; {mcfg.n_experts} experts top-"
            f"{mcfg.top_k}, routing groups of {mcfg.moe_group}): prefill S={MOE_PREFILL_S} against "
            f"forward's last position {err:.2e} (tolerance {LM_PREFILL_TOL:.2e}), aux "
            f"{float(aux):.4f}")
        log(f"[time] lm {MOE_ARCH} ({MOE_LAYERS} layers) prefill B=1 S={MOE_PREFILL_S} on {name} "
            f"({smi}): {ms:.1f} ms, {MOE_PREFILL_S / ms * 1e3:.0f} tokens/s, device busy "
            f"{_busy(ms, busy)}, peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        mdecode = steps.lm_decode_step(mcfg)
        toks = synthetic.lm_batch(5, MOE_DECODE_BATCH, MOE_DECODE_STEPS, mcfg.vocab,
                                  device)["tokens"]
        cache = tf.init_kv_cache(mcfg, MOE_DECODE_BATCH, MOE_DECODE_STEPS, device=device)
        mtimes = []
        for t in range(MOE_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = mdecode(mparams, {"token": toks[:, t]}, cache)
            torch.cuda.synchronize()
            mtimes.append(1e3 * (time.perf_counter() - t0))
            check(lg.shape == (MOE_DECODE_BATCH, mcfg.vocab)
                  and bool(torch.isfinite(lg.float()).all()),
                  f"{MOE_ARCH}: decode step {t} gave non-finite logits")
        ms = sum(mtimes[1:]) / (len(mtimes) - 1)
        log(f"[time] lm {MOE_ARCH} ({MOE_LAYERS} layers) decode B={MOE_DECODE_BATCH} on {name} "
            f"({smi}): {ms:.2f} ms a step after the first ({MOE_DECODE_STEPS} steps, logits "
            f"finite), {MOE_DECODE_BATCH / ms * 1e3:.0f} tokens/s")
        del mparams, cache, toks, last, last_full
        torch.cuda.empty_cache()

        # -- (h) the five full configs on the meta device ------------------------------
        counts = []
        for arch in LM_IDS:
            full_cfg = get_arch(arch).config
            meta = ckpt_lib.flatten_tree(tf.init_params(full_cfg, device="meta"))
            n = sum(t.numel() for t in meta.values())
            check(n == full_cfg.param_count() and all(t.is_meta for t in meta.values()),
                  f"{arch}: {n} elements on the meta device, param_count {full_cfg.param_count()}")
            counts.append(f"{arch} {n}")
        log(f"[lm] the full configs' trees on the meta device, elements == param_count: "
            + ", ".join(counts))

        # -- (i) SMOKE: one card step per arch against the CPU's ------------------------
        for arch in LM_IDS + (GNN_ARCH,):
            loss, norm, worst = _zoo_smoke_step(arch, device)
            check(loss <= ZOO_LOSS_TOL and norm <= ZOO_LOSS_TOL and worst <= ZOO_GRAD_TOL,
                  f"{arch} SMOKE card step: loss {loss:.2e}, norm {norm:.2e}, moments "
                  f"{worst:.2e} from the CPU's")
            log(f"[lm] {arch} SMOKE: one train step on the card against the CPU's from the same "
                f"weights and batch: loss {loss:.2e}, gradient norm {norm:.2e} (tolerance "
                f"{ZOO_LOSS_TOL}), Adam's moments {worst:.2e} of each leaf's largest entry "
                f"(tolerance {ZOO_GRAD_TOL})")

        # -- (j) meshgraphnet: the launcher, then minibatch_lg twice -------------------
        gbase = ["--arch", GNN_ARCH, "--full", "--device", str(device), "--steps", str(GNN_STEPS)]
        gout, gtext = _quiet(train_mod.main, gbase)
        glosses = gout["losses"]
        check(gtext.rstrip().endswith("done.") and sorted(glosses) == list(range(1, GNN_STEPS + 1))
              and all(bool(torch.isfinite(v)) for v in glosses.values()),
              f"{GNN_ARCH}: the launcher said {gtext}")
        del gout
        gcfg = dataclasses.replace(get_arch(GNN_ARCH).config, d_node_in=GNN_LG_FEAT)
        gbatch = synthetic.gnn_batch(0, GNN_LG_NODES, GNN_LG_EDGES, gcfg, device)
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(2):
            gparams = gnn_lib.init_params(gcfg, torch.Generator(device=device).manual_seed(0),
                                          device)
            gp, gopt, gm = steps.gnn_train_step(gcfg, train_mod.ADAM)(
                gparams, steps.init_opt_state(gparams), gbatch)
            gy = steps.gnn_infer_step(gcfg)(gp, gbatch)
            runs.append((gm["loss"], gm["grad_norm"], gp, gopt, gy))
        (l1, n1, p1, o1, y1), (l2, n2, p2, o2, y2) = runs
        check(torch.equal(l1, l2) and torch.equal(n1, n2) and _equal_trees(p1, p2)
              and _equal_trees(o1.mu, o2.mu) and _equal_trees(o1.nu, o2.nu)
              and torch.equal(y1, y2),
              f"{GNN_ARCH}: two runs at minibatch_lg's size differ")
        check(math.isfinite(float(l1)) and math.isfinite(float(n1))
              and y1.shape == (GNN_LG_NODES, gcfg.d_out) and bool(torch.isfinite(y1).all()),
              f"{GNN_ARCH}: loss {float(l1)}, norm {float(n1)} at minibatch_lg's size")
        gstate = [p1, o1]
        gstep, ginfer = steps.gnn_train_step(gcfg, train_mod.ADAM), steps.gnn_infer_step(gcfg)

        def gnn_train_fn():
            gstate[0], gstate[1], _ = gstep(gstate[0], gstate[1], gbatch)

        gms = host_ms(gnn_train_fn, GNN_TIME_STEPS)
        gbusy = device_busy_ms(gnn_train_fn, 1)
        ims = host_ms(lambda: ginfer(gstate[0], gbatch), GNN_TIME_STEPS)
        ibusy = device_busy_ms(lambda: ginfer(gstate[0], gbatch), 1)
        log(f"[gnn] {GNN_ARCH} --full through the launcher ({GNN_STEPS} steps on "
            f"{train_mod.GNN_NODES} nodes, {train_mod.GNN_EDGES} edges): losses "
            f"{', '.join(f'{float(glosses[i]):.4f}' for i in sorted(glosses))}; at minibatch_lg's "
            f"size ({GNN_LG_NODES} nodes, {GNN_LG_EDGES} edges, d_feat {GNN_LG_FEAT}, "
            f"{gcfg.param_count()} parameters by param_count) gnn_train_step then gnn_infer_step "
            f"twice from one seed: loss {float(l1):.6f}, gradient norm {float(n1):.6f}, the "
            f"parameters, Adam's moments and the outputs bit-identical between the runs")
        log(f"[time] gnn {GNN_ARCH} minibatch_lg on {name} ({smi}): train step {gms:.2f} ms "
            f"(host clock, synced, {GNN_TIME_STEPS} steps; device busy {_busy(gms, gbusy)}), "
            f"infer {ims:.2f} ms (device busy {_busy(ims, ibusy)}), "
            f"{GNN_LG_EDGES / gms * 1e3:.0f} edges/s trained, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del runs, gstate, p1, p2, o1, o2, y1, y2, gbatch, gparams
        torch.cuda.empty_cache()
        log(f"[lm] phase passed in {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _dryrun_cell(cell):
    """The dry run of one (arch, shape) on both production meshes (a worker
    process: the step's costs are counted once when the shapes agree)."""
    import torch

    torch.set_num_threads(1)
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.launch.dryrun import run_cell

    cache = {}
    return [run_cell(cell[0], cell[1], multi_pod, cache) for multi_pod in (False, True)]


def _dryrun_order(cells):
    """The longest first: the LM train cells, then the LM prefills, by size."""
    from repro_torch.configs.registry import get_arch

    def cost(cell):
        entry = get_arch(cell[0])
        size = entry.config.param_count() if entry.family == "lm" else 0
        return (cell[1] == "train_4k", cell[1] == "prefill_32k", size)

    return sorted(cells, key=cost, reverse=True)


def _cell_args(cell, device, gen):
    """``cell``'s meta arguments drawn on ``device`` in valid ranges: ids below
    the rows of the table they index (or the graph's nodes), masks mostly
    ones, Adam's moments zeros, other floats N(0, 1) x 0.05."""
    import torch

    from repro_torch.train.checkpoint import flatten_tree, unflatten_tree

    params = cell.abstract_args[0]

    def high(name):
        if name in ("senders", "receivers"):
            return cell.meta["nodes"]
        if name == "sparse_ids":
            return params["tables"].shape[1]
        if name in ("hist_cates", "target_cate"):
            return params["cate_table"].shape[0]
        if name == "hist_ids" and "user_table" in params:
            return params["user_table"].shape[0]
        return params["item_table"].shape[0]

    def draw(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        name = re.findall(r"\['(\w+)'\]", key)[-1]
        if "/.mu/" in key or "/.nu/" in key:
            return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
        if leaf.dtype == torch.bool:
            return torch.rand(leaf.shape, generator=gen, device=device) < 0.95
        if not leaf.dtype.is_floating_point:
            return torch.randint(0, high(name), leaf.shape, generator=gen, device=device,
                                 dtype=leaf.dtype)
        if name.endswith("_mask"):
            mask = (torch.rand(leaf.shape, generator=gen, device=device) < 0.9).to(leaf.dtype)
            mask[..., 0] = 1.0
            return mask
        return (torch.randn(leaf.shape, generator=gen, device=device) * 0.05).to(leaf.dtype)

    flat = flatten_tree(cell.abstract_args)
    return unflatten_tree(cell.abstract_args, [draw(k, v) for k, v in flat.items()])


def _bits_equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.reshape(-1).view(view), b.reshape(-1).view(view))
    return torch.equal(a, b)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def tooling_phase(seed, device, name, smi, dry, t_dry):
    """Phase 13: gradient compression at llama3.2-1b's full size, the dry run
    of every cell on both production meshes (``dry``: its records to come
    from the worker processes, started at ``t_dry``, while the card works),
    five cells at their production shapes on the card, and llama3.2-1b's
    parameters laid out over a (4, 2) mesh and gathered back. Adds no
    kernel. Returns the dry run's records."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_cost import step_costs
    from repro_torch.launch.mesh import LeafMesh
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import compression as comp
    from repro_torch.train.checkpoint import flatten_tree

    t_phase = time.perf_counter()
    # (b), the dry run of all 40 cells on both meshes, runs in the workers meanwhile
    # -- (a) gradient compression at llama3.2-1b's full size --------------------
    cfg = registry.get_arch(LM_ARCH).config
    shapes = {k: tuple(t.shape) for k, t in
              flatten_tree(tf.init_params(cfg, device="meta")).items()}
    n_elems = sum(math.prod(v) for v in shapes.values())
    check(n_elems == cfg.param_count(), f"{LM_ARCH}: {n_elems} gradient elements")
    gen = torch.Generator(device=device).manual_seed(seed)
    grads = {k: torch.empty(v, dtype=torch.float32, device=device) for k, v in shapes.items()}
    err = comp.init_error_feedback(grads)
    round_ms, host_s, checked = [], [], list(shapes)
    for r in range(COMP_ROUNDS):
        for g in grads.values():
            g.normal_(generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, scales, new_err = comp.compress_with_feedback(grads, err)
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for k in checked:
            hq, hs, he = comp.compress_with_feedback({"x": grads[k].cpu()}, {"x": err[k].cpu()})
            check(_bits_equal(q[k].cpu(), hq["x"]) and _bits_equal(scales[k].cpu(), hs["x"])
                  and _bits_equal(new_err[k].cpu(), he["x"]),
                  f"compression round {r}, {k}: the card's payload, scale or error differs "
                  f"from the CPU's")
        host_s.append(time.perf_counter() - t0)
        if r == 0 and host_s[0] > COMP_HOST_S_A_ROUND:
            checked = [k for k in shapes if k == "['embed']"
                       or math.prod(shapes[k]) < COMP_SMALL]
        err = new_err
        del q, scales, new_err
    which = ("every leaf" if len(checked) == len(shapes) else
             f"every leaf in round 0, then {', '.join(checked)} "
             f"({sum(math.prod(shapes[k]) for k in checked)} elements)")
    one_pass, two_pass = 13 * n_elems, 21 * n_elems
    log(f"[tools] compress_with_feedback over {LM_ARCH}'s {len(shapes)} gradient leaves "
        f"({n_elems} f32 elements) on {name} ({smi}): rounds "
        f"{', '.join(f'{ms:.2f}' for ms in round_ms)} ms; HBM bound "
        f"{1e3 * two_pass / HBM_BYTES_PER_S:.2f} ms ({two_pass / 1e9:.1f} GB: g and e read "
        f"twice, once for the max, q and e written; one pass would be "
        f"{1e3 * one_pass / HBM_BYTES_PER_S:.2f} ms, {one_pass / 1e9:.1f} GB); q, scale and "
        f"the new error bit-identical to the CPU's ({which}; host side "
        f"{', '.join(f'{t:.1f}' for t in host_s)} s a round)")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    dist.init_process_group("nccl", init_method=addr, world_size=1, rank=0,
                            device_id=torch.device(device))
    try:
        q, scales, want_err = comp.compress_with_feedback(grads, err)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, got_err = comp.compressed_psum(grads, err)
        torch.cuda.synchronize()
        psum_ms = 1e3 * (time.perf_counter() - t0)
        for k in shapes:
            check(_bits_equal(mean[k], comp.dequantize_int8(q[k], scales[k]))
                  and _bits_equal(got_err[k], want_err[k]),
                  f"compressed_psum over one NCCL rank: {k} differs from the dequantized tree")
    finally:
        dist.destroy_process_group()
    del grads, err, q, scales, want_err, mean, got_err
    torch.cuda.empty_cache()
    log(f"[tools] compressed_psum over a one-rank NCCL group ({addr}): the mean equals the "
        f"dequantized tree and the new error the compression's, every leaf, bit for bit "
        f"({psum_ms:.1f} ms); group destroyed")

    # -- (c) five cells at their production shapes on one leaf of the card --------
    card = LeafMesh((1, 1), ("data", "model"), [device])
    gen = torch.Generator(device=device).manual_seed(seed)
    for arch, shape in CARD_CELLS:
        cell = registry.build_cell(arch, shape, card)
        meta = step_costs(cell.fn, *cell.abstract_args)
        want_bytes = dryrun.argument_bytes(cell)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        args = _cell_args(cell, device, gen)
        leaves = [t for t in flatten_tree(args).values() if isinstance(t, torch.Tensor)]
        got_bytes = sum(t.untyped_storage().nbytes() for t in leaves)
        check(all(t.device == torch.device(device) for t in leaves) and got_bytes == want_bytes,
              f"{arch}/{shape}: its arguments take {got_bytes} bytes on the card, the dry "
              f"run says {want_bytes}")
        torch.cuda.reset_peak_memory_stats()
        costs = step_costs(cell.fn, *args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        check(costs["flops"] == meta["flops"],
              f"{arch}/{shape}: {costs['flops']} FLOPs on the card, {meta['flops']} on meta")
        out = cell.fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CELL_TIME_STEPS):
            out = cell.fn(*args)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / CELL_TIME_STEPS
        floats = [t for t in flatten_tree(out).values()
                  if isinstance(t, torch.Tensor) and t.dtype.is_floating_point]
        check(floats and all(bool(torch.isfinite(t).all()) for t in floats),
              f"{arch}/{shape}: the step's outputs are not finite")
        log(f"[tools] {arch}/{shape} ({cell.kind}) on one leaf of {name} ({smi}): arguments "
            f"{got_bytes / 1e9:.3f} GB == the dry run's; {costs['flops']:.4e} FLOPs a step on "
            f"the card == meta; {ms:.3f} ms a step ({costs['flops'] / ms / 1e9:.2f} TFLOP/s); "
            f"peak {peak / 1e9:.3f} GB on the card beside "
            f"{meta['unsharded_peak_bytes'] / 1e9:.3f} GB on meta (not gated)")
        del args, leaves, out, floats
        torch.cuda.empty_cache()

    # -- (d) llama3.2-1b's parameters over a (4, 2) mesh of the card ---------------
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                            device=device)
    mesh = LeafMesh(*SHARD_MESH, [device] * math.prod(SHARD_MESH[0]))
    meta_mesh = LeafMesh(*SHARD_MESH, ["meta"] * math.prod(SHARD_MESH[0]))
    want_leaf = shd.tree_leaf_bytes(tf.init_params(cfg, device="meta"),
                                    shd.lm_param_sharding(meta_mesh, cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = shd.shard_tree(params, shd.lm_param_sharding(mesh, cfg))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    pieces = list(flatten_tree(sharded).values())
    per_leaf = [sum(v.leaf_bytes()[i] for v in pieces) for i in range(mesh.n_leaves)]
    check(set(per_leaf) == {want_leaf},
          f"sharded {LM_ARCH}: leaves hold {per_leaf} bytes, the dry run says {want_leaf}")
    t0 = time.perf_counter()
    back = shd.gather_tree(sharded, device)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    check(all(_bits_equal(a, b) for a, b in zip(flatten_tree(back).values(),
                                                flatten_tree(params).values())),
          f"sharded {LM_ARCH}: gather_tree did not give the parameters back bit for bit")
    log(f"[tools] {LM_ARCH}'s parameters ({cfg.param_count()} bf16) over LeafMesh"
        f"{SHARD_MESH[0]} on {name}: {want_leaf / 1e9:.4f} GB on each of the "
        f"{mesh.n_leaves} leaves == the dry run's per-leaf figure; laid out in "
        f"{shard_s:.2f} s, gathered back bit-identical in {gather_s:.2f} s")
    del params, sharded, pieces, back
    torch.cuda.empty_cache()

    # -- (b) the dry run's records ----------------------------------------------------
    t0 = time.perf_counter()
    records = [r for pair in dry.get(timeout=1200) for r in pair]
    dry_s = time.perf_counter() - t_dry
    waited = time.perf_counter() - t0
    bad = [f"{r['arch']}|{r['shape']}|{r['mesh']}: {r.get('error')}"
           for r in records if not r.get("ok")]
    check(len(records) == 80 and not bad, f"dry run: {len(records)} records, failed {bad}")
    by_family = {}
    for r in records:
        entry = registry.get_arch(r["arch"])
        by_family.setdefault(entry.family, []).append(r)
        if r["mesh"] != "16x16":
            continue
        n = 256
        cell = registry.build_cell(r["arch"], r["shape"], LeafMesh(
            (16, 16), ("data", "model"), ["meta"] * n))
        elems = sum(t.numel() for t in flatten_tree(cell.abstract_args[0]).values())
        # two param_counts of the reference miss parts of their own trees
        # (ROADMAP, reference-side caveats): those cells are held to the tree
        want = r["meta"]["params"]
        if entry.family == "gnn":  # mlp_layers layers an MLP counted, mlp_layers + 1 built
            h = cell.meta["d_hidden"]
            want += (3 + 2 * cell.meta["n_layers"]) * (h * h + h)
        elif r["arch"] == "dien":  # target_proj and the attention's 36 -> 1 layer uncounted
            want += entry.config.beh_dim * entry.config.gru_dim + 36 + 1
        check(elems == want, f"dry run {r['arch']}/{r['shape']}: {elems} parameter elements, "
                             f"want {want}")
    log(f"[tools] dry run: {len(records)} (cell, mesh) pairs on the meta device in {dry_s:.1f} s "
        f"over {DRYRUN_WORKERS} processes ({sum(r['run_s'] for r in records):.1f} s of steps; "
        f"{waited:.1f} s waited after (a), (c) and (d)); parameter elements == meta['params'] "
        f"(meshgraphnet and dien, whose param_count misses part of the tree: == the tree)")
    for family, recs in sorted(by_family.items()):
        top = max(recs, key=lambda r: r["memory"]["argument_bytes"])
        flops = ", ".join(f"{r['arch']}/{r['shape']} {r['cost']['flops_per_step']:.3e}"
                          for r in recs if r["mesh"] == "16x16")
        log(f"[tools] dry run {family}: largest per-leaf arguments "
            f"{top['memory']['argument_bytes'] / 1e9:.3f} GB ({top['arch']}/{top['shape']} on "
            f"{top['mesh']}); FLOPs a step: {flops}")
    log(f"[tools] phase passed in {time.perf_counter() - t_phase:.1f} s")
    return records


def _hillclimb_variant(item):
    """One hillclimb variant's record on 16x16 or 2x16x16 (a worker process:
    the meta device and a fake process group, nothing on the card)."""
    import logging

    import torch

    torch.set_num_threads(1)
    logging.disable(logging.WARNING)  # DTensor's note on the CPU mesh's all-to-all
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.launch import hillclimb as hc

    cell, variant, multi_pod = item
    mesh = hc.mesh_name(multi_pod)
    try:
        return cell, variant, mesh, hc.run_variant(cell, variant, multi_pod)
    except Exception as e:  # noqa: BLE001 — reported and failed by the phase
        return cell, variant, mesh, {"ok": False, "error": f"{type(e).__name__}: {e}"}


def _hillclimb_order(variants):
    """The longest first: llama3-405b's train step (2x16x16's microbatch16,
    split over data alone on an unmerged mesh, first of all), grok's
    prefill, the GNN, then the two-tower cell; 2x16x16 before 16x16."""
    rank = {"llama405b_train": 0, "grok_prefill": 1, "gnn_ogb": 2, "tt_retrieval": 3}
    items = [(c, v, mp) for mp in (True, False) for c in variants for v in variants[c]]
    return sorted(items, key=lambda it: (rank[it[0]], (it[0], it[1], it[2]) !=
                                         ("llama405b_train", "microbatch16", True), not it[2]))


def _dry_as_hillclimb(r):
    """A dry-run record (``launch/dryrun.run_cell``) as (cell, variant, mesh,
    record) under hillclimb's keys, as the reference's records are kept."""
    coll = r["collectives"]
    return r["arch"], r["shape"], r["mesh"], {
        "flops": r["cost"]["flops_per_device"], "whole": r["cost"]["flops_per_step"],
        "wire_bytes": sum(coll["wire_bytes_per_device"].values()),
        "peak_gib": r["memory"]["peak_bytes_per_device"] / 2**30,
        "replicated": coll["replicated"], "replicated_at": coll["replicated_at"],
        "strided": coll["strided"]}


def _hold_records(records) -> None:
    """Each record (cell, variant, mesh, record) beside the JAX reference's
    GSPMD record of the same cell on the same mesh (``HC_RECORDS``, full
    depth), held: FLOPs a device equal (the llama3-405b train variants and
    decode on 16x16, as before) or at most the reference's (every other
    record), or for the MoE cells at most ``HC_MOE_TARGETS``'s multiples of
    the whole step's share (the record's ``whole`` over 256 or 512) and of
    the reference's; wire at most the reference's, nothing replicated, no
    strided layout redistributed, the peak at most twice the reference's.
    Faults A-D's figures are printed beside their figures before the
    repair (``HC_FAULTS``)."""
    refs, per_file = {}, {}
    for path, n in HC_RECORDS.items():
        with open(os.path.join(ROOT, path)) as f:
            recs = json.load(f)
        check(len(recs) == n, f"{path}: {len(recs)} records, {n} wanted")
        per_file.update(dict.fromkeys(recs, path))
        refs.update(recs)
    held, got = {}, {}
    for c, v, mesh, r in records:
        key = f"{c}|{v}|{mesh}"
        if key not in refs:
            continue
        ref = refs[key]
        got[key] = r
        moe = HC_MOE_TARGETS.get((c, v))
        share = r["whole"] / (512 if mesh == "2x16x16" else 256) if moe else None
        log(f"[hillclimb] {key} beside the reference: FLOPs {r['flops']:.6e} / "
            f"{ref['flops']:.6e} ({r['flops'] / ref['flops']:.4f}x"
            + (f"; {r['flops'] / share:.4f}x the step's share {share:.6e}" if moe else "")
            + f"), wire {r['wire_bytes']:.4e} / "
            f"{ref['wire_bytes']:.4e} B ({r['wire_bytes'] / ref['wire_bytes']:.4f}x), peak "
            f"{r['peak_gib']:.3f} / {ref['peak_gib']:.3f} GiB ({r['peak_gib'] / ref['peak_gib']:.3f}x), "
            f"replicated {r['replicated'] or 'none'}, strided {r['strided'] or 'none'}")
        if moe:
            at_share, at_ref = moe
            check(at_share is None or r["flops"] <= at_share * share,
                  f"hillclimb {key}: {r['flops']} FLOPs a device over {at_share}x the step's "
                  f"share {share:.0f}")
            check(at_ref is None or r["flops"] <= at_ref * ref["flops"],
                  f"hillclimb {key}: {r['flops']} FLOPs a device over {at_ref}x the "
                  f"reference's {ref['flops']:.0f}")
        else:
            exact = mesh == "16x16" and (c == "llama405b_train"
                                         or (c, v) == ("llama3-405b", "decode_32k"))
            check(r["flops"] == ref["flops"] if exact else r["flops"] <= ref["flops"],
                  f"hillclimb {key}: {r['flops']} FLOPs a device against the reference's "
                  f"{ref['flops']:.0f} ({'equal' if exact else 'at most'} wanted)")
        check(r["wire_bytes"] <= ref["wire_bytes"],
              f"hillclimb {key}: wire {r['wire_bytes']} B above the reference's {ref['wire_bytes']}")
        check(r["replicated"] == {}, f"hillclimb {key}: replicated {r['replicated_at']}")
        check(r["strided"] == {}, f"hillclimb {key}: strided layouts redistributed {r['strided']}")
        check(r["peak_gib"] <= 2 * ref["peak_gib"],
              f"hillclimb {key}: peak {r['peak_gib']:.3f} GiB over twice the reference's "
              f"{ref['peak_gib']:.3f}")
        held[per_file[key]] = held.get(per_file[key], 0) + 1
    check(held == HC_RECORDS and sum(held.values()) == len(refs) == 132,
          f"hillclimb: {sum(held.values())} of the {len(refs)} records held, by file {held}")
    for fault, key, metric, before in HC_FAULTS:
        field = {"flops": "flops", "wire": "wire_bytes", "peak": "peak_gib"}[metric]
        log(f"[hillclimb] fault {fault} {key}: {metric} {before}x the reference's before the "
            f"repair -> {got[key][field] / refs[key][field]:.4f}x")
    log(f"[hillclimb] {sum(held.values())} records held against the reference's GSPMD records: "
        + ", ".join(f"{n} of {os.path.basename(p)}" for p, n in held.items()))


def _tt_variant_args(abstract, cfg, device, gen):
    """Real arguments for a tt_retrieval variant's meta ``abstract`` ones on
    ``device``: the two-tower's seeded parameters and a linear binarizer,
    one query's history, codes in [0, 2^levels), their inverse norms with
    ``HC_PLANTED`` set, f32 candidate embeddings or candidate ids."""
    import torch

    from repro_torch.kernels.sdc import ref as sdc_ref
    from repro_torch.models.recsys import two_tower as tt

    params_s, batch_s = abstract
    params = tt.init_params(cfg, gen, device=device)
    if "binarizer" in params_s:
        emb, code = params_s["binarizer"]["W"][0].shape
        params["binarizer"] = {
            "W": [torch.randn((emb, code), generator=gen, device=device) / emb**0.5
                  for _ in params_s["binarizer"]["W"]],
            "R": [torch.randn((code, emb), generator=gen, device=device) / code**0.5
                  for _ in params_s["binarizer"]["R"]]}
    batch = {"hist_ids": torch.randint(0, cfg.user_vocab, tuple(batch_s["hist_ids"].shape),
                                       generator=gen, device=device, dtype=torch.int32),
             "hist_mask": torch.ones(tuple(batch_s["hist_mask"].shape), device=device)}
    if "cand_codes" in batch_s:
        n, code = batch_s["cand_codes"].shape
        codes = torch.randint(0, 2**HC_LEVELS, (n, code), generator=gen, device=device,
                              dtype=torch.int32).to(torch.int8)
        inv = sdc_ref.doc_inv_norms(codes, HC_LEVELS)
        for doc, value in HC_PLANTED.items():
            inv[doc] = value
        batch.update(cand_codes=codes, cand_inv=inv)
    if "cand_emb" in batch_s:
        batch["cand_emb"] = torch.randn(tuple(batch_s["cand_emb"].shape), generator=gen,
                                        device=device)
    if "cand_ids" in batch_s:
        batch["cand_ids"] = torch.randint(0, cfg.item_vocab, tuple(batch_s["cand_ids"].shape),
                                          generator=gen, device=device, dtype=torch.int32)
    return params, batch


def hillclimb_phase(seed, device, name, smi, dry_records, hill, t_dry):
    """Phase 14: the card's rates beside the roofline constants, the
    two-tower cell's five variants at production shapes on the card (three
    BEBR variants identical, every sdc_topk call held against its plain
    version), and hillclimb's 26 variants dry on both meshes (``hill``: their
    records to come from the worker processes, queued at ``t_dry`` behind
    phase 13's); their records and phase 13's (``dry_records``), 132 in all,
    held against the reference's. Returns the kernels JSON row of the BEBR
    variants' sdc_topk."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.sdc import defaults
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.mesh import LeafMesh
    from repro_torch.parallel import spmd

    t_phase = time.perf_counter()
    # (c), the 26 variants on both meshes, run in the workers meanwhile
    # -- (a) the card's rates beside the constants --------------------------------
    x = torch.empty(RATE_COPY_BYTES, dtype=torch.uint8, device=device)
    y = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: y.copy_(x), RATE_REPS)
    hbm = 2 * RATE_COPY_BYTES / (copy_ms / 1e3)  # read once, written once
    del x, y
    gen = torch.Generator(device=device).manual_seed(seed)
    n = RATE_MM_N
    a = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    bf16_ms = cuda_ms(lambda: torch.matmul(a, b), RATE_REPS)
    ai = torch.randint(-128, 128, (n, n), generator=gen, device=device,
                       dtype=torch.int32).to(torch.int8)
    bi = torch.randint(-128, 128, (n, n), generator=gen, device=device,
                       dtype=torch.int32).to(torch.int8)
    int8_ms = cuda_ms(lambda: torch._int_mm(ai, bi), RATE_REPS)
    del a, b, ai, bi
    torch.cuda.empty_cache()
    bf16 = 2 * n**3 / (bf16_ms / 1e3)
    int8 = 2 * n**3 / (int8_ms / 1e3)
    log(f"[hillclimb] rates of {name} ({smi}): HBM {hbm / 1e12:.4f} TB/s (a "
        f"{RATE_COPY_BYTES / 2**30:.0f} GiB device-to-device copy, {copy_ms:.3f} ms) beside "
        f"HBM_BW {defaults.HBM_BW / 1e12:.2f}; bf16 torch.matmul {n}^3 {bf16 / 1e12:.2f} "
        f"TFLOP/s ({bf16_ms:.3f} ms) beside PEAK_FLOPS {defaults.PEAK_FLOPS / 1e12:.1f}; "
        f"torch._int_mm {n}^3 {int8 / 1e12:.2f} TOP/s ({int8_ms:.3f} ms) beside the int8 "
        f"peak {2 * defaults.PEAK_FLOPS / 1e12:.1f}; LINK_BW {defaults.LINK_BW / 1e9:.0f} "
        f"GB/s x N_LINKS {defaults.N_LINKS}: not measured (one card, no NVLink peer)")

    # -- (b) tt_retrieval's five variants at production shapes on the card -------
    cfg = get_arch("two-tower-retrieval").config
    one = LeafMesh((1, 1), ("data", "model"), [device])
    meta_one = LeafMesh((1, 1), ("data", "model"), ["meta"])
    terms, outs, times = {}, {}, {}
    for variant, build in hc.VARIANTS["tt_retrieval"].items():
        terms[variant] = hc._measure(*build(meta_one), meta_one)  # one device, on meta
    addr = f"tcp://127.0.0.1:{_free_port()}"
    dist.init_process_group("nccl", init_method=addr, world_size=1, rank=0,
                            device_id=torch.device(device))
    try:
        with spmd.bind(one):
            sdc_mod.sdc_topk.launches = 0
            with _SdcTopkCalls() as seen:
                for variant, build in hc.VARIANTS["tt_retrieval"].items():
                    fn, shardings, abstract = build(one)
                    args = _tt_variant_args(abstract, cfg, device,
                                            torch.Generator(device=device).manual_seed(seed))
                    if variant == "bebr_sdc_merge":
                        def call(fn=fn, args=args, shardings=shardings):
                            v, i = spmd.run(fn, args, shardings)
                            return v.to_local(), i.to_local()
                    else:
                        def call(fn=fn, args=args):
                            return fn(*args)
                    outs[variant] = call()
                    torch.cuda.synchronize()
                    if variant == "bebr_sdc_merge":  # the main path's launches end here
                        launches = sdc_mod.sdc_topk.launches
                        held = seen.check("tt_retrieval BEBR variants", launches)
                    times[variant] = (call, args)
            for variant, (call, args) in times.items():
                times[variant] = cuda_ms(call, HC_TIME_REPS)
            del args
    finally:
        dist.destroy_process_group()
    check(launches == 3, f"the three BEBR variants launched sdc_topk {launches} times")
    (vb, ib), (vf, i_f), (vm, im) = (outs[v] for v in ("bebr_sdc", "bebr_sdc_fullmesh",
                                                      "bebr_sdc_merge"))
    check(_bits_equal(vb, vf) and _bits_equal(vb, vm) and torch.equal(ib, i_f)
          and torch.equal(ib, im),
          "bebr_sdc, bebr_sdc_fullmesh and bebr_sdc_merge differ on the card")
    top = set(ib[0].tolist())
    planted = sorted(d for d in HC_PLANTED if d in top)
    check(bool(planted), "no candidate with an inverse norm <= 0 reached the top k")
    for variant, (v, i) in outs.items():
        check(tuple(v.shape) == (1, HC_K) and bool(torch.isfinite(v).all())
              and bool((v[:, :-1] >= v[:, 1:]).all()), f"tt_retrieval {variant} on the card")
    log(f"[hillclimb] tt_retrieval on {name} ({smi}): bebr_sdc, bebr_sdc_fullmesh and "
        f"bebr_sdc_merge (one-rank NCCL group) give identical scores and ids over "
        f"{HC_CANDIDATES} codes, {len(planted)} candidates with an inverse norm <= 0 in "
        f"the top {HC_K}; sdc_topk launched {launches} times ({held}), each exactly its "
        f"plain version")
    for variant in hc.VARIANTS["tt_retrieval"]:
        t = terms[variant]
        log(f"[time] hillclimb tt_retrieval|{variant} on {name} ({smi}): {times[variant]:.3f} "
            f"ms a call (CUDA events, {HC_TIME_REPS} calls) beside its one-device roofline "
            f"terms compute {t['compute_ms']:.4f} ms, memory {t['memory_ms']:.4f} ms "
            f"({t['flops']:.4e} FLOPs, {t['bytes']:.4e} eager bytes)")
    del outs

    # the kernel at the variants' shape, for the kernels line
    g = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, 2**HC_LEVELS, (HC_CANDIDATES, HC_CODE_DIM), generator=g,
                          device=device, dtype=torch.int32).to(torch.int8)
    from repro_torch.kernels.sdc import ref as sdc_ref

    inv = sdc_ref.doc_inv_norms(codes, HC_LEVELS)
    q = torch.randint(0, 2**HC_LEVELS, (1, HC_CODE_DIM), generator=g, device=device,
                      dtype=torch.int32).to(torch.int8)
    kw = dict(n_levels=HC_LEVELS, k=HC_K)
    v, i = sdc_mod.sdc_topk(q, codes, inv, **kw)
    pv, pi = sdc_mod.sdc_topk_torch(q, codes, inv, **kw)
    check(torch.equal(v, pv) and torch.equal(i, pi),
          "sdc_topk at [1, 1,000,000] differs from its plain version")
    ms = cuda_ms(lambda: sdc_mod.sdc_topk(q, codes, inv, **kw), 50)
    plain_ms = cuda_ms(lambda: sdc_mod.sdc_topk_torch(q, codes, inv, **kw), 5)
    nbytes = HC_CANDIDATES * (HC_CODE_DIM + 4) + HC_CODE_DIM + HC_K * 8
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * (2 * HC_CANDIDATES * HC_CODE_DIM * 2) / INT8_OPS_PER_S
    # (d) the library yardstick (timed only): the query padded with zero
    # rows to torch._int_mm's least row count, the product, the epilogue
    # and torch.topk of the query's row
    from repro_torch.core.binarize_lib import sdc_affine_epilogue

    q_pad = torch.zeros((INT_MM_MIN_ROWS, HC_CODE_DIM), dtype=torch.int8, device=device)
    q_pad[0] = q[0]
    sq = q.to(torch.int32).sum(-1, keepdim=True)
    sd = codes.to(torch.int32).sum(-1)[None, :]

    def library():
        dot = torch._int_mm(q_pad, codes.t())[:1]
        s = sdc_affine_epilogue(dot, sq + sd, dim=HC_CODE_DIM, n_levels=HC_LEVELS,
                                inv_norm=inv[None, :])
        return torch.topk(s, HC_K)

    lib_v = library().values
    check(bool(torch.isfinite(lib_v).all())
          and torch.allclose(lib_v.sort(-1).values, v.sort(-1).values, rtol=1e-6, atol=0),
          "the library yardstick's top k scores differ from sdc_topk's")
    library_ms = cuda_ms(library, 50)
    log(f"[time] sdc_topk int8 Q=1 N={HC_CANDIDATES} D={HC_CODE_DIM} k={HC_K} (the BEBR "
        f"variants' scan) on {name} ({smi}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"HBM bound {bytes_ms:.5f} ms, int8 op bound {ops_ms:.5f} ms, library "
        f"{library_ms:.4f} ms (torch._int_mm over the query padded to {INT_MM_MIN_ROWS} "
        f"rows + the epilogue + torch.topk; its scores the kernel's)")
    row = dict(name="sdc_topk_int8_bebr", route="cuda", source=SOURCE,
               replaces=REPLACES[False], launches=launches,
               max_abs_err=float((v - pv).abs().max()), ms=ms, plain_ms=plain_ms,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=library_ms)
    del codes, inv, q, q_pad
    torch.cuda.empty_cache()

    # -- (c) the dry records -------------------------------------------------------
    t0 = time.perf_counter()
    records = hill.get(timeout=1000)
    dry_s = time.perf_counter() - t_dry
    waited = time.perf_counter() - t0
    bad = [f"{c}|{v}|{m}: {r.get('error')}" for c, v, m, r in records if not r.get("ok")]
    check(len(records) == 52 and not bad, f"hillclimb: {len(records)} records, failed {bad}")
    for c, v, m, r in records:
        wire = ", ".join(f"{k} {x:.4e}" for k, x in r["collectives"].items() if x)
        log(f"[hillclimb] {c}|{v}|{m}: {r['flops']:.4e} FLOPs, {r['bytes']:.4e} bytes, wire "
            f"{r['wire_bytes']:.4e} B ({wire or 'none'}) a device; compute "
            f"{r['compute_ms']:.4f} ms, memory {r['memory_ms']:.4f} ms, collective "
            f"{r['collective_ms']:.4f} ms (H100 constants); peak {r['peak_gib']:.3f} GiB; "
            f"replicated {r['replicated'] or 'none'}; {r['run_s']} s")
    rec = {(c, v, m): r for c, v, m, r in records}
    merge, bebr = (rec[("tt_retrieval", v, "16x16")] for v in ("bebr_sdc_merge", "bebr_sdc"))
    check(merge["flops"] == bebr["flops"] == 18_064_384
          and merge["collectives"]["all-gather"] == 12_000,
          "hillclimb tt_retrieval: the merge's FLOPs or all-gather wire moved")
    _hold_records(records + [_dry_as_hillclimb(r) for r in dry_records])
    log(f"[hillclimb] 26 variants dry on 16x16 and on 2x16x16, done {dry_s:.1f} s after "
        f"phase 13's dry run started, over its {DRYRUN_WORKERS} processes "
        f"({sum(r['run_s'] for r in rec.values()):.1f} s of steps; {waited:.1f} s waited after "
        f"(a) and (b))")
    log(f"[hillclimb] phase passed in {time.perf_counter() - t_phase:.1f} s")
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

    from repro_torch.core.binarize_lib import (
        BinarizerConfig,
        init_binarizer,
        make_eager_encode_fn,
        make_encode_fn,
    )
    from repro_torch.data.synthetic import clustered_corpus_torch
    from repro_torch.index.flat import FlatFloat, FlatSDC
    from repro_torch.kernels import _build
    from repro_torch.kernels.sdc import sdc as sdc_mod
    from repro_torch.kernels.sdc.ops import sdc_search_torch
    from repro_torch.launch import serving
    from repro_torch.launch.serve import encode_codes, recall_at_k

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
    # the corpus went through the captured encode: its first batch and its
    # ragged tail equal the eager twin's codes
    eager = make_eager_encode_fn(model)
    tail = (args.docs - 1) // (1 << 17) * (1 << 17)  # the last batch's first row
    for lo, hi in ((0, min(args.docs, 1 << 17)), (tail, args.docs)):
        check(torch.equal(d_codes[lo:hi], eager(docs[lo:hi])),
              f"corpus codes [{lo}, {hi}) from the captured encode differ from the eager ones")
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
        results, stats = serving.serve_batches(encode, search, batches, config=cfg)
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
    encode_repair("flat int8", encode, eager, lambda q: indexes[False].search(q, K), batches,
                  cfg, name, smi)

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

    IVF_NLIST, IVF_NPROBE, IVF_SEED, IVF_KMEANS_ITERS = ivf_params()

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
    encode_repair(f"IVF int8 nprobe {IVF_NPROBE}", encode, eager,
                  lambda q: ivf.search(ivfs[False], q, nprobe=IVF_NPROBE, k=K), batches, cfg,
                  name, smi)

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
    row, hnsw_data = hnsw_phase(model, encode, eager, cfg, args.seed, device, name, smi)
    kernels.append(row)

    # -- 8d. the distributed engine, four leaves on the card ---------------------
    kernels += engine_phase(d_codes, indexes, encode, eager, batches, cfg, device, name, smi,
                            hnsw_data)

    # -- 8e. the replicated serving tier, the CLI's routed run ----------------------
    kernels += routed_phase(d_codes, indexes, encode, eager, batches, cfg, device, name, smi,
                            hnsw_data, kernels)
    del hnsw_data

    # -- 8f. the autotuner over the same codes ---------------------------------------
    autotune_phase(d_codes, indexes, encode, batches, device, name, smi)

    # -- 9. the dlrm-rm2 serving forward at full width ------------------------
    del indexes, d_codes
    torch.cuda.empty_cache()
    kernels.append(dlrm_phase(args.seed, device, name, smi))

    # -- 10. binarizer training and the upgrade at the CLI's width -----------------
    torch.cuda.empty_cache()
    kernels.append(training_phase(args.seed, device, name, smi))
    log(f"[smoke] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    # -- 11. the recsys zoo trained and served, and the examples ----------------------
    torch.cuda.empty_cache()
    kernels += zoo_phase(device, name, smi)

    # -- 12. the LM and GNN families at full width ------------------------------------
    torch.cuda.empty_cache()
    lm_gnn_phase(device, name, smi)

    # -- 13. compression, the dry run of every cell, cells and sharded state on the card --
    # (the dry run's 80 records and, queued behind them, phase 14's 52, in the
    # worker processes while the card works)
    import multiprocessing

    from repro_torch.configs import registry
    from repro_torch.launch import hillclimb as hc

    torch.cuda.empty_cache()
    pool = multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS)
    try:
        t_dry = time.perf_counter()
        dry = pool.map_async(_dryrun_cell, _dryrun_order(registry.all_cells()), chunksize=1)
        hill = pool.map_async(_hillclimb_variant, _hillclimb_order(hc.VARIANTS), chunksize=1)
        dry_records = tooling_phase(args.seed, device, name, smi, dry, t_dry)

        # -- 14. the hillclimb: rates, the two-tower variants on the card, 52 records dry ---
        torch.cuda.empty_cache()
        kernels.append(hillclimb_phase(args.seed, device, name, smi, dry_records, hill, t_dry))
    finally:
        pool.terminate()
        pool.join()

    log("kernels: " + ", ".join(f"{k['name']} matched, launches={k['launches']}"
                                for k in kernels))
    log(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
