"""Backfill-free model upgrade demo on the PyTorch/CUDA port (paper
§3.2.3, Figure 2 right), the counterpart of ``examples/compat_upgrade.py``.

    PYTHONPATH=src python examples/compat_upgrade_torch.py [--device cuda|cpu]
        [--steps 200] [--bc-steps 300]

A backbone upgrade ships a better encoder whose float space has drifted.
Instead of re-encoding the index, BEBR trains phi_new with the
backward-compatible objective: new queries search the OLD binary index
immediately. The finale drives the same models through the port's live
serving tier (``launch/{proxy,lifecycle,serving}.py``): a 2-replica
router on the v1 index takes mixed v1/v2 ``SearchRequest`` traffic while
a rolling swap migrates it to the v2 index, the ``CompatibilityMatrix``
covering the transition window. The corpora and the BC batches are the
reference's numpy draws; the binarizers' initial weights are the port's
own, so recall matches the reference's statistically.
"""

import argparse
import copy

import numpy as np
import torch

import repro_torch.core.losses as L
from repro_torch import prng
from repro_torch.core.binarize_lib import BinarizerConfig, binarize_eval, make_encode_fn
from repro_torch.core.trainer import (
    TrainConfig,
    bc_train_step,
    binarizer_progress,
    init_train_state,
    train_step,
)
from repro_torch.data.synthetic import pair_batches, upgraded_corpus
from repro_torch.device import resolve_device
from repro_torch.kernels.sdc.sdc import select_topk
from repro_torch.launch import lifecycle, proxy, serving
from repro_torch.train import optim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or cpu")
    ap.add_argument("--steps", type=int, default=200, help="phi_old training steps")
    ap.add_argument("--bc-steps", type=int, default=300, help="BC training steps of phi_new")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    dim, code, levels = 128, 64, 4
    old_docs, old_queries, new_docs, new_queries, gt = upgraded_corpus(0, 10_000, 256, dim)

    cfg = TrainConfig(
        binarizer=BinarizerConfig(input_dim=dim, code_dim=code, n_levels=levels, hidden_dim=256),
        queue=L.QueueConfig(length=2048, dim=code, top_k=32),
        adam=optim.AdamConfig(lr=1e-3, clip_norm=5.0),
        temperature=0.2, bc_weight=1.0, bc_influence_weight=4.0,
    )

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    def recall(q_model, q_emb, d_model, d_emb, k=10):
        bq, bd = binarize_eval(q_model, t(q_emb)), binarize_eval(d_model, t(d_emb))
        _, idx = select_topk(L.cosine(bq, bd), k)
        return float(np.mean(np.any(idx.cpu().numpy() == gt[:, None], -1)))

    print("1) v1 in production: train phi_old, build the binary index")
    old = init_train_state(cfg, prng.key(0, dev), dev)
    initial = copy.deepcopy(old.model)
    gen = pair_batches(old_docs, 1, 128, noise=0.05, device=dev)
    for _ in range(args.steps):
        a, p = next(gen)
        old, _ = train_step(old, a, p, cfg)
    training = {"v1": binarizer_progress(old, initial, *next(gen), cfg)}  # held-out pairs
    out = {"old_old": recall(old.model, old_queries, old.model, old_docs)}
    print(f"   (old q, old index) recall@10 = {out['old_old']:.3f}")

    print("2) v2 backbone ships — naive deploy without compatibility:")
    out["naive"] = recall(old.model, new_queries, old.model, old_docs)
    print(f"   (new q through phi_old, old index) recall@10 = {out['naive']:.3f}   "
          "<- regression!")

    print("3) BEBR-BC: train phi_new against the frozen old index (Eq. 9-10)")
    new = init_train_state(cfg, prng.key(7, dev), dev)
    new = new._replace(model=copy.deepcopy(old.model), m_model=copy.deepcopy(old.model))
    rng = np.random.default_rng(11)
    for _ in range(args.bc_steps):
        idx = rng.integers(0, old_docs.shape[0], 128)
        new, _ = bc_train_step(new, old.model, t(new_docs[idx]), t(old_docs[idx]), cfg)
    # L_BC on held-out documents: phi_old (the warm start) against phi_new
    idx = np.random.default_rng(12).integers(0, old_docs.shape[0], 128)
    training["v2_bc"] = binarizer_progress(new, old.model, t(new_docs[idx]), t(old_docs[idx]),
                                           cfg, old=old.model)
    out["compat"] = recall(new.model, new_queries, old.model, old_docs)
    print(f"   (new q through phi_new, OLD index, zero backfill) recall@10 = {out['compat']:.3f}")
    print("   -> the new model serves immediately; the index refresh "
          "(billions of docs) happens lazily or never.")

    print("4) live tier migration: 2 replicas on the v1 index, mixed "
          "v1/v2 traffic, rolling swap to v2 (compat covers the window)")
    enc_v1, enc_v2 = make_encode_fn(old.model), make_encode_fn(new.model)
    snap_v1 = lifecycle.CorpusSnapshot(codes=enc_v1(old_docs).cpu().numpy(), n_levels=levels,
                                       embedding_version="v1")
    snap_v2 = lifecycle.CorpusSnapshot(codes=enc_v2(new_docs).cpu().numpy(), n_levels=levels,
                                       embedding_version="v2")
    builder = lifecycle.make_builder("flat", k=10, device=dev)
    search_v1 = builder.build(snap_v1)

    batch = 64
    v1_batches = [old_queries[i:i + batch] for i in range(0, old_queries.shape[0], batch)]
    v2_batches = [new_queries[i:i + batch] for i in range(0, new_queries.shape[0], batch)]
    serving.warmup_replicas([(enc_v1, search_v1), (enc_v2, search_v1)],
                            v1_batches[:1] + v2_batches[:1])

    # bc-trained encoders work BOTH ways across the anchored output space:
    # v2 floats search the v1 index and v1 floats the v2 index
    compat = proxy.CompatibilityMatrix()
    compat.register("v2", "v1", enc_v2)
    compat.register("v1", "v2", enc_v1)
    router = proxy.QueryRouter(proxy.ReplicaSet([(enc_v1, search_v1)] * 2, share_device=True),
                               compat=compat)
    for r in (0, 1):
        router.set_version(r, lifecycle.builder_version(builder, snap_v1))

    stream, meta = [], []
    for _ in range(4):
        for i, (b, nb) in enumerate(zip(v1_batches, v2_batches)):
            stream.append(serving.SearchRequest(queries=b, embedding_version="v1"))
            meta.append(("v1", i))
            stream.append(serving.SearchRequest(queries=nb, embedding_version="v2"))
            meta.append(("v2", i))

    controller = lifecycle.RollingSwapController(
        router, lifecycle.make_builder("flat", k=10, device=dev),
        warm_batches=v2_batches[:1], encode_fn=enc_v2,
    )
    try:
        results, report = lifecycle.run_stream_with_swap(
            router, stream, controller=controller, snapshot=snap_v2,
            swap_after=len(stream) // 3,
        )
        stats = router.stats()
    finally:
        router.close()

    hits = {"v1": [], "v2": []}
    for (ver, i), r in zip(meta, results):
        ids = r[1].cpu().numpy()
        g = np.asarray(gt)[i * batch: i * batch + ids.shape[0]]
        hits[ver].append(float(np.mean(np.any(ids == g[:, None], -1))))
    finals = [pr["embedding_version"] for pr in stats["per_replica"]]
    out["mixed_v1"], out["mixed_v2"] = float(np.mean(hits["v1"])), float(np.mean(hits["v2"]))
    print(f"   mixed traffic across the migration: recall@10 "
          f"v1={out['mixed_v1']:.3f} v2={out['mixed_v2']:.3f}")
    print(f"   -> {report.swapped} replica(s) migrated in "
          f"{report.total_s * 1e3:.0f} ms under live traffic, "
          f"{stats['compat_dispatches']} compat-encoded dispatch(es) "
          f"covered the window, final versions {finals}, "
          "zero results lost.")
    out.update(swapped=report.swapped, finals=finals, lost=sum(r is None for r in results),
               compat_dispatches=stats["compat_dispatches"], training=training)
    return out


if __name__ == "__main__":
    main()
