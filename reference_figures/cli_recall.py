#!/usr/bin/env python3
"""The JAX reference's recall@10 at its serve CLI's width, on the CPU: the
figures ``chip_smoke.py``'s training phase holds the port's training to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python reference_figures/cli_recall.py \
        [--queries 2048] [--ckpt-cache DIR]

Trains the binarizer as ``python -m repro.launch.serve`` does with its
defaults (``clustered_corpus(0, 20000, ., 256)``, the CLI's
``TrainConfig``, 300 steps of 256 pairs, seed 0, through its digest
cache), then its ``--upgrade-after`` next version
(``backbone_upgrade(., 5)``, ``bc_train_binarizer``, 300 steps, seed 7),
and prints one JSON line of recall@10 over ``--queries`` queries: the
trained codes through a flat SDC index, the untrained ones (the initial
weights of seed 0, what ``--steps 0`` serves), the float baseline, the v2
queries encoded by the BC-trained binarizer on the v1 index, and the v1
binarizer on the v2 queries (a warm start without BC training). The
corpus's documents are drawn before its queries, so they, and the trained
weights, do not depend on ``--queries``.

This script runs the reference only; it is not part of the PyTorch port.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import repro.core.losses as losses_lib
from repro.core import BinarizerConfig, TrainConfig, make_encode_fn
from repro.data import synthetic
from repro.index.flat import FlatFloat, FlatSDC
from repro.launch import lifecycle, serve
from repro.train import optim


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-cache", default=None, metavar="DIR")
    args = ap.parse_args()

    dim, code_dim, levels, k = 256, 128, 4, 10  # the CLI's defaults
    docs, queries, gt = synthetic.clustered_corpus(0, 20000, args.queries, dim)
    bcfg = BinarizerConfig(input_dim=dim, code_dim=code_dim, n_levels=levels,
                           hidden_dim=2 * dim)
    tcfg = TrainConfig(
        binarizer=bcfg,
        queue=losses_lib.QueueConfig(length=4096, dim=code_dim, top_k=64),
        adam=optim.AdamConfig(lr=2e-3, clip_norm=5.0),
    )
    t0 = time.perf_counter()
    old = serve.train_binarizer(docs, tcfg, steps=args.steps, cache_dir=args.ckpt_cache)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new_docs = synthetic.backbone_upgrade(docs, 5)
    new_queries = synthetic.backbone_upgrade(queries, 5)
    bc = serve.bc_train_binarizer(old, docs, new_docs, tcfg, steps=args.steps)
    bc_s = time.perf_counter() - t0

    def recall(ids) -> float:
        return float(np.mean(np.any(np.asarray(ids) == gt[:, None], -1)))

    def flat_recall(ckpt, q) -> float:
        index = FlatSDC.build(serve.encode_codes(ckpt, docs, bcfg), levels, backend="xla")
        enc = make_encode_fn(ckpt.params, ckpt.bn_state, bcfg)
        return recall(index.search(enc(q), k)[1])

    untrained = serve.train_binarizer(docs, tcfg, steps=0, cache_dir=args.ckpt_cache)
    enc_old = make_encode_fn(old.params, old.bn_state, bcfg)
    enc_bc = make_encode_fn(bc.params, bc.bn_state, bcfg)
    snap_v1 = lifecycle.CorpusSnapshot(codes=np.asarray(enc_old(docs)), n_levels=levels,
                                       embedding_version="v1")
    search_v1 = lifecycle.make_builder("flat", k=k, backend="xla").build(snap_v1)
    out = {
        "queries": args.queries,
        "steps": args.steps,
        "digest": old.digest,
        "recall_trained": flat_recall(old, queries),
        "recall_untrained": flat_recall(untrained, queries),
        "recall_float": recall(FlatFloat.build(docs).search(queries, k)[1]),
        "recall_bc_on_v1": recall(search_v1(enc_bc(new_queries))[1]),
        "recall_warm_only_on_v1": recall(search_v1(enc_old(new_queries))[1]),
        "train_s": train_s,
        "bc_train_s": bc_s,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
