"""Distributed BEBR serving demo on the PyTorch/CUDA port (paper Figure 5:
proxy -> leaf -> merge); the counterpart of ``examples/serve_bebr.py``.

    PYTHONPATH=src python examples/serve_bebr_torch.py [--index flat|hnsw]
        [--replicas N] [--router P] [--autotune] [--device cuda|cpu]

Eight engine leaves share one device (the card by default, raising
without one; ``--device cpu`` runs the plain scoring path) and are carved
into ``--replicas`` submeshes (``launch/mesh.make_replica_meshes``). Each
replica shards the whole binary index over its own leaves and runs the
port's proxy/leaf/merge engine (``index/engine.py``): a flat leaf is one
``sdc_topk`` launch, an HNSW leaf hop one ``sdc_gather_topk``. A
``QueryRouter`` (``launch/proxy.py``) spreads query batches across the
replicas: admission queue -> router -> replica pipelines -> engine
leaves. It reports agreement with the exact single search and the index
bytes.

``--index hnsw`` swaps the exhaustive leaf scan for the batched-frontier
graph search: one NSW graph per leaf (host-side build), walked on the
device. The corpus shrinks to 16,000 documents because the NSW build is
host-side O(N^2).

``--autotune`` tunes the leaves' scan geometry (and the bi-granular
rerank's group) keyed on the rows a leaf holds, at the demo's batch;
the plans persist under ``$REPRO_BEBR_CACHE`` (default
``~/.cache/repro-bebr``), as do the binarizer's weights (``--ckpt-cache``).
Leaves that share a device run one after another, so the demo's QPS
carries that; agreement, routing, failover and the rolling swap are what
it shows.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.binarize_lib import BinarizerConfig, make_encode_fn
from repro_torch.core.trainer import TrainConfig
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels.sdc import ref as R
from repro_torch.kernels.sdc.ops import select_topk
from repro_torch.launch import autoscale, binarizer_cache, faults, lifecycle, proxy, serving
from repro_torch.launch.mesh import make_replica_meshes
from repro_torch.launch.serve import encode_codes
from repro_torch.train import optim

N_LEAVES = 8  # engine leaves on the one device; the --replicas submeshes split these


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", choices=["flat", "hnsw"], default="flat")
    ap.add_argument("--replicas", type=int, default=2,
                    help="engine replicas; the 8 leaves are split into this "
                         "many disjoint submeshes")
    ap.add_argument("--router", choices=sorted(proxy.ROUTING_POLICIES),
                    default="round-robin", help="replica routing policy")
    ap.add_argument("--tier-spec", default=None, metavar="SPEC.json",
                    help="declarative tier spec (launch/autoscale.py): "
                         "starts the tier at min_replicas and runs the "
                         "shed-pressure autoscaler over the stream. The 8 "
                         "leaves are carved into max_replicas submeshes up "
                         "front, so every replica the autoscaler may add "
                         "already owns its leaves; scale-ups build the "
                         "engine on submesh i via builder.build(snapshot, "
                         "replica=i). Overrides --replicas/--router")
    ap.add_argument("--steps", type=int, default=150,
                    help="binarizer training steps (first run only; the "
                         "checkpoint is cached under a content digest)")
    ap.add_argument("--ckpt-cache", default=None, metavar="DIR",
                    help="binarizer checkpoint cache dir (default: "
                         "$REPRO_BEBR_CACHE, else ~/.cache/repro-bebr)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the per-leaf scan's launch geometry (and the "
                         "bi-granular rerank's group) on the live shard "
                         "sizes before serving; winners persist in the tune "
                         "cache ($REPRO_BEBR_CACHE), so every replica and "
                         "later launch shares one plan; bit-identical "
                         "scores either way (launch/autotune.py)")
    ap.add_argument("--coarse-levels", type=int, default=0, metavar="C",
                    help="bi-granular engine (flat only): per-leaf coarse "
                         "scan over the first C levels, post-merge "
                         "full-level rerank of --k-coarse survivors; "
                         "0 disables")
    ap.add_argument("--k-coarse", type=int, default=0, metavar="K'",
                    help="bi-granular engine: survivors rescored at full "
                         "depth; 0 disables (set with --coarse-levels)")
    ap.add_argument("--swap-after", type=int, default=0, metavar="N",
                    help="after N routed batches, rolling-swap every "
                         "replica's index from a fresh corpus snapshot "
                         "(drain -> rebuild on its submesh -> warm -> "
                         "canary re-probe) under the live stream; "
                         "0 disables")
    ap.add_argument("--probe-every", type=float, default=0.0, metavar="S",
                    help="period (s) of the router's canary health "
                         "re-probe; revives unhealthy replicas; 0 off")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection on the replica "
                         "fns (launch/faults.py grammar), e.g. "
                         "'r0.search.fail@3' — pair with --probe-every "
                         "to watch failover + revival on the sharded tier")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    spec = None
    if args.tier_spec:
        try:
            spec = autoscale.TierSpec.from_file(args.tier_spec)
        except autoscale.InvalidTierSpec as e:
            ap.error(f"--tier-spec: {e}")
        args.replicas = spec.min_replicas
        args.router = spec.router
    # The submesh carve is sized for the LARGEST tier the spec allows:
    # scale-up must only instantiate an engine on an already-reserved
    # submesh, never re-partition live leaves.
    n_slots = spec.max_replicas if spec is not None else args.replicas
    if N_LEAVES % n_slots:
        ap.error(f"replica slots ({n_slots}) must divide {N_LEAVES}")
    if bool(args.coarse_levels) != bool(args.k_coarse):
        ap.error("--coarse-levels and --k-coarse must be set together")
    if args.coarse_levels and args.index != "flat":
        ap.error("--coarse-levels requires --index flat (per-leaf coarse "
                 "scan + post-merge rerank)")
    device = resolve_device(args.device)
    per = N_LEAVES // n_slots
    shape = (per // 2, 2) if per % 2 == 0 else (per, 1)

    dim, code, levels = 128, 64, 4
    n_docs = 100_000 if args.index == "flat" else 16_000
    docs, queries, gt = clustered_corpus(0, n_docs, 64, dim, n_clusters=256)

    # binarize: a recurrent-MLP binarizer trained emb2emb on the corpus and
    # checkpointed under a content digest (launch/binarizer_cache.py): only
    # the first launch pays for training.
    bcfg = BinarizerConfig(input_dim=dim, code_dim=code, n_levels=levels,
                           hidden_dim=2 * dim)
    tcfg = TrainConfig(
        binarizer=bcfg,
        queue=losses_lib.QueueConfig(length=2048, dim=code, top_k=32),
        adam=optim.AdamConfig(lr=2e-3, clip_norm=5.0),
    )
    t0 = time.time()
    ckpt = binarizer_cache.trained_binarizer(docs, tcfg, steps=args.steps, seed=0,
                                             cache_dir=args.ckpt_cache, device=device)
    verb = "trained" if ckpt.trained else "loaded cached"
    print(f"binarizer: {verb} checkpoint {ckpt.digest} in "
          f"{time.time() - t0:.1f}s (hidden={bcfg.hidden_dim}, {args.steps} steps)")
    # the per-batch encode, shared across replicas: one CUDA-graph replay
    # a batch on the card, where the eager forward's launches would fight
    # the leaf scans for the GIL
    encode = make_encode_fn(ckpt.model)
    d_codes, q_codes = encode_codes(ckpt.model, docs), encode(queries)

    leaves = [device] * N_LEAVES
    meshes = make_replica_meshes(n_slots, shape=shape, devices=leaves)
    print(f"replica submeshes: {n_slots} x {dict(zip(meshes[0].axes, meshes[0].shape))} — "
          f"{args.index} index of {d_codes.shape[0]} codes sharded over {per} leaves per "
          f"replica on {device}, router={args.router}"
          + (f" (serving {args.replicas}, autoscaling up to {n_slots})"
             if spec is not None else ""))

    # The same builder serves the initial tier AND the rolling swap: each
    # replica's index is builder.build(snapshot, replica=i), the engine
    # over ITS submesh, closed over its placed corpus shards (replicas on
    # one device share them). For hnsw the host-side sharded graph is built
    # once per snapshot digest and shared across replicas.
    snapshot = lifecycle.CorpusSnapshot(codes=d_codes.cpu().numpy(), n_levels=levels)
    batch = 16
    # Tuned launch plans for the per-leaf scan (and the post-merge rerank
    # in bi-granular mode), keyed on the PER-LEAF shard size: that is the
    # corpus each kernel launch sees. Plans never change scores; the
    # agreement check below holds either way.
    block_plan = None
    if args.autotune:
        from repro_torch.launch import autotune

        n_shard = -(-d_codes.shape[0] // per)  # rows per leaf, padded up
        block_plan = {}
        for kind in ("scan", "rerank"):
            tp = autotune.tuned_block_plan(
                kind, code_dim=code, n_shard=n_shard, k=(args.k_coarse or 10),
                n_levels=levels, sample_q=batch, device=device,
            )
            block_plan[kind] = tp.plan
            print(f"tune {kind}: block_q={tp.plan.block_q} "
                  f"block_n={tp.plan.block_n} ({tp.plan.source})")
    builder = lifecycle.EngineBuilder(
        meshes, index=args.index, n_levels=levels, k=10,
        M=16, ef_construction=48, ef=64, beam=16,
        coarse_levels=args.coarse_levels or None,
        k_coarse=args.k_coarse or None,
        block_plan=block_plan,
    )
    replica_fns = [(encode, builder.build(snapshot, replica=i))
                   for i in range(args.replicas)]

    batches = [queries[i:i + batch] for i in range(0, queries.shape[0], batch)]
    # Warm every replica's encode + engine for both drivers outside the
    # timed region (worker threads carry their own library state, a ragged
    # tail is its own shape and its own captured graph).
    serving.warmup_replicas(replica_fns, batches)

    rounds = 4
    stream = batches * rounds
    enc0, search0 = replica_fns[0]
    t0 = time.time()
    serving.serve_sequential(enc0, search0, stream)
    dt_seq = time.time() - t0
    # Chaos wrapping AFTER warmup and the sequential baseline: the fault
    # schedule is a function of the call index, so earlier traffic must not
    # consume it, and the faults target the routed tier.
    replica_fns, injectors = faults.apply_chaos(replica_fns, args.chaos)
    t0 = time.time()
    # share_device: the replicas' leaves share one device, and a scan holds
    # its gate to its end. The router is driven directly so a mid-stream
    # rolling swap / canary probe can run against the live tier.
    router = proxy.QueryRouter(
        proxy.ReplicaSet(replica_fns, config=serving.ServingConfig(),
                         share_device=n_slots > 1),
        policy=args.router,
    )
    controller = None
    if args.swap_after:
        controller = lifecycle.RollingSwapController(
            router, builder, warm_batches=batches[:1], encode_fn=encode)
    scaler = None
    try:
        if args.probe_every:
            router.start_health_probe(batches[0], interval=args.probe_every)
        if spec is not None:
            # Engine tiers hand the autoscaler a replica factory: slot i's
            # search closure is the engine over submesh i, built by the SAME
            # EngineBuilder the rolling swap uses.
            scaler = autoscale.Autoscaler(
                router, spec,
                replica_factory=lambda slot: (encode, builder.build(snapshot, replica=slot)),
                warm_batches=batches[:1],
                on_event=lambda msg: print(f"autoscale: {msg}"),
                device=device,
            )
            scaler.start()
        results, swap_report = lifecycle.run_stream_with_swap(
            router, stream, controller=controller, snapshot=snapshot,
            swap_after=args.swap_after,
        )
    finally:
        if scaler is not None:
            scaler.stop()
        for inj in injectors.values():
            inj.release()  # a still-stuck scan would wedge close()'s joins
        router.close()
    stats = router.stats()
    dt = time.time() - t0
    ids = torch.cat([torch.as_tensor(i).cpu() for _, i in results[: len(batches)]], 0)

    _, ei = select_topk(R.sdc_ref(q_codes, d_codes, levels), 10)
    ei = ei.cpu()
    agree = np.mean([
        len(set(ids[i].tolist()) & set(ei[i].tolist())) / 10 for i in range(q_codes.shape[0])
    ])
    recall = float((ids.to(torch.int64) == torch.as_tensor(gt)[:, None]).any(-1).float().mean())
    n_q = queries.shape[0] * rounds
    print(f"leaf/merge top-10 vs exact agreement: {agree:.3f}")
    print(f"ground-truth recall@10: {recall:.3f}")
    print(f"sequential (1 replica): {n_q / dt_seq:.0f} QPS | routed "
          f"({args.replicas} replicas): {n_q / dt:.0f} QPS on {N_LEAVES} leaves sharing "
          f"{device} (p50 {stats['latency_p50_ms']:.1f} ms, p99 "
          f"{stats['latency_p99_ms']:.1f} ms, scan waiting for input "
          f"{100 * stats['device_idle_frac']:.0f}%)")
    for srep in stats["per_replica"]:
        print(f"  replica {srep['replica']}: {srep['requests']} req "
              f"({srep['queries']} queries), scan waiting for input "
              f"{100 * srep['device_idle_frac']:.0f}%, generation {srep['generation']}")
    if swap_report is not None:
        rep = swap_report
        print(f"rolling swap -> {rep.version.tag}: {rep.swapped} replica(s) "
              f"re-indexed under the live stream in {rep.total_s * 1e3:.0f} ms")
        for row in rep.replicas:
            print(f"  replica {row['replica']}: drain {row['drain_s'] * 1e3:.0f} ms, build "
                  f"{row['build_s'] * 1e3:.0f} ms, warm {row['warm_s'] * 1e3:.0f} ms, probe "
                  f"{row['probe_s'] * 1e3:.0f} ms")
    if args.probe_every:
        print(f"canary re-probe every {args.probe_every}s: {stats['revivals']} revival(s)")
    if scaler is not None:
        sm = scaler.summary()
        print(f"autoscale [{sm['replicas_min']}, {sm['replicas_max']}]: "
              f"{sm['scale_ups']} up / {sm['scale_downs']} down over "
              f"{sm['decisions']} tick(s); ended at {sm['replicas']} replica(s)")
    for i, inj in sorted(injectors.items()):
        fired = ", ".join(f"{s}#{n}:{k}" for s, n, k in inj.log) or "none"
        print(f"chaos replica {i}: {len(inj.log)} fault(s) fired ({fired})")
    packed = (code * levels + 7) // 8 + 4
    print(f"index bytes: {d_codes.shape[0] * packed / 2**20:.1f} MiB vs "
          f"float {docs.nbytes / 2**20:.1f} MiB")
    return dict(agreement=float(agree), recall=recall, stats=stats, swap=swap_report,
                block_plan=block_plan)


if __name__ == "__main__":
    main()
