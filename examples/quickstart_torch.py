"""BEBR quickstart on the PyTorch/CUDA port, the counterpart of
``examples/quickstart.py``: binarize a float corpus, build an index, search.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu] [--steps 300]

Train the recurrent binarizer on float embeddings (task-agnostic emb2emb:
no backbone, no raw data), compress the index 16x, and search with SDC
(``sdc_topk`` on the card) beside the float index's exact search. The
corpus is the reference's numpy draw, bit for bit; the binarizer's
initial weights are the port's own, so recall matches the reference's
statistically.
"""

import argparse
import copy
import time

import numpy as np

import repro_torch.core.losses as L
from repro_torch import prng
from repro_torch.core.binarize_lib import BinarizerConfig, make_encode_fn
from repro_torch.core.trainer import (
    TrainConfig,
    binarizer_progress,
    init_train_state,
    train_step,
)
from repro_torch.data.synthetic import clustered_corpus, pair_batches
from repro_torch.device import resolve_device
from repro_torch.index.flat import FlatFloat, FlatSDC
from repro_torch.train import optim

DIM, CODE, LEVELS = 256, 128, 4  # 8192-bit float -> 512-bit code (16x)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or cpu")
    ap.add_argument("--steps", type=int, default=300, help="binarizer training steps")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("1) corpus: 20k docs, 128 queries, 256-dim float embeddings")
    docs, queries, gt = clustered_corpus(0, 20000, 128, DIM, n_clusters=192)

    print(f"2) train recurrent binarizer (emb2emb, momentum queue; {args.steps} steps)")
    cfg = TrainConfig(
        binarizer=BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=LEVELS, hidden_dim=512),
        queue=L.QueueConfig(length=4096, dim=CODE, top_k=64),
        adam=optim.AdamConfig(lr=2e-3, clip_norm=5.0),
    )
    state = init_train_state(cfg, prng.key(0, dev), dev)
    gen = pair_batches(docs, 1, 256, noise=0.08, device=dev)
    initial = copy.deepcopy(state.model)
    t0 = time.time()
    loss = float("nan")
    for _ in range(args.steps):
        a, p = next(gen)
        state, metrics = train_step(state, a, p, cfg)
        loss = metrics["loss"]
    print(f"   trained {args.steps} steps in {time.time()-t0:.0f}s, loss={float(loss):.3f}")
    trained = binarizer_progress(state, initial, *next(gen), cfg)  # held-out pairs

    print("3) encode corpus to recurrent binary codes")
    enc = make_encode_fn(state.model)
    d_codes, q_codes = enc(docs), enc(queries)

    print("4) build indexes + search")
    ff = FlatFloat.build(docs, device=dev)
    sdc = FlatSDC.build(d_codes, LEVELS, device=dev)
    _, idx_f = ff.search(queries, 10)
    _, idx_b = sdc.search(q_codes, 10)

    def r(idx):
        return float(np.mean(np.any(idx.cpu().numpy() == gt[:, None], -1)))

    print(f"   float index: {ff.nbytes()/2**20:6.1f} MiB  recall@10={r(idx_f):.3f}")
    print(f"   BEBR  index: {sdc.nbytes()/2**20:6.1f} MiB  recall@10={r(idx_b):.3f}  "
          f"({100*(1-sdc.nbytes()/ff.nbytes()):.0f}% smaller)")
    return {"recall_float": r(idx_f), "recall_bebr": r(idx_b), "training": {"binarizer": trained}}


if __name__ == "__main__":
    main()
