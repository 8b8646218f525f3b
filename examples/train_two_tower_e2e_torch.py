"""End-to-end pipeline on the PyTorch/CUDA port, the counterpart of
``examples/train_two_tower_e2e.py``: train a two-tower retrieval model
(the paper's EBR backbone setting) for a few hundred steps, extract the
catalog's item embeddings, binarize them with BEBR, and serve retrieval
through the SDC scan.

    PYTHONPATH=src python examples/train_two_tower_e2e_torch.py [--steps 400]
        [--binarizer-steps 200] [--device cuda|cpu] [--ckpt DIR]

This is the full production pipeline of Figure 2: backbone training ->
float embeddings -> task-agnostic binarization -> binary index ->
serving, with checkpointing (kill and re-run to resume; the reference's
checkpoint layout, under ``build/bebr_two_tower_ckpt_torch`` by default,
not the reference example's directory, so neither resumes the other's
run). On the card the search is one ``sdc_topk`` launch over the
20,000-item catalog; the port draws its own initial weights, so its
quality figures match the reference's statistically, not bit for bit.
"""

import argparse
import copy
import os
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import losses as L
from repro_torch.core.binarize_lib import BinarizerConfig, make_encode_fn
from repro_torch.core.trainer import (
    TrainConfig,
    binarizer_progress,
    init_train_state,
    train_step,
    training_progress,
)
from repro_torch.device import resolve_device
from repro_torch.index.flat import FlatSDC
from repro_torch.models.recsys import two_tower as tt
from repro_torch.train import checkpoint as ck
from repro_torch.train import optim, steps

DEFAULT_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "build", "bebr_two_tower_ckpt_torch")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--binarizer-steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~5M-param two-tower model (vocab-dominated, as in production)
    cfg = tt.TwoTowerConfig(name="tt-e2e", embed_dim=128, tower_mlp=(256, 128),
                            user_vocab=20_000, item_vocab=20_000, hist_len=16)
    print(f"model: {cfg.param_count()/1e6:.1f}M params")

    params = tt.init_params(cfg, prng.key(0, dev), dev)
    opt = steps.init_opt_state(params)
    step = steps.tt_train_step(cfg, optim.AdamConfig(lr=5e-3))

    # structured interactions: users of taste-group g watch and click
    # items of group g (so the towers learn a real geometry).
    n_groups = 64
    items_per_group = cfg.item_vocab // n_groups

    def make_batch(i, batch=256):
        rng = np.random.default_rng(1000 + i)
        g = rng.integers(0, n_groups, batch)
        hist = (g[:, None] * items_per_group
                + rng.integers(0, items_per_group, (batch, cfg.hist_len))).astype(np.int32)
        pos = (g * items_per_group + rng.integers(0, items_per_group, batch)).astype(np.int32)
        return {
            "hist_ids": torch.from_numpy(hist).to(dev),
            "hist_mask": torch.ones((batch, cfg.hist_len), device=dev),
            "pos_items": torch.from_numpy(pos).to(dev),
            "item_logq": torch.zeros((batch,), device=dev),
        }

    start = 0
    if ck.latest_step(args.ckpt) is not None:
        tree, start = ck.restore(args.ckpt, steps.train_state_tree(params, opt))
        params, opt = steps.train_state_from_tree(tree)
        print(f"[resume] from step {start}")

    initial = {k: t.detach().clone() for k, t in ck.flatten_tree(params).items()}
    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        params, opt, metrics = step(params, opt, make_batch(i))
        losses.append(metrics["loss"])
        if (i + 1) % 50 == 0:
            print(f"step {i+1}: loss={float(metrics['loss']):.4f} ({time.time()-t0:.0f}s)")
            ck.save(args.ckpt, i + 1, steps.train_state_tree(params, opt))

    # ---- extract item-tower embeddings for the whole catalog ----
    print("extracting item embeddings (the float index)...")
    with torch.no_grad():
        item_emb = torch.cat([
            tt.item_embed(params, torch.arange(lo, min(lo + 8192, cfg.item_vocab), device=dev),
                          cfg)
            for lo in range(0, cfg.item_vocab, 8192)])

    # ---- BEBR: binarize the catalog (emb2emb, no backbone access) ----
    # Anchors are QUERY tower embeddings, positives their clicked items'
    # embeddings: the binarizer learns a code space in which both sides
    # rank correctly.
    print("training binarizer on query-item embedding pairs...")
    bcfg = TrainConfig(
        binarizer=BinarizerConfig(input_dim=128, code_dim=64, n_levels=4, hidden_dim=256),
        queue=L.QueueConfig(length=4096, dim=64, top_k=64),
        adam=optim.AdamConfig(lr=2e-3, clip_norm=5.0),
    )
    bstate = init_train_state(bcfg, prng.key(1, dev), dev)
    b_initial = copy.deepcopy(bstate.model)

    def pairs(i):
        b = make_batch(i)
        with torch.no_grad():
            return (tt.query_embed(params, b["hist_ids"], b["hist_mask"], cfg),
                    tt.item_embed(params, b["pos_items"], cfg))

    for i in range(args.binarizer_steps):
        bstate, _ = train_step(bstate, *pairs(5000 + i), bcfg)
    training = {"binarizer": binarizer_progress(bstate, b_initial, *pairs(9000), bcfg)}
    if losses:  # the backbone trained in this run, not only restored
        training["two_tower"] = training_progress(initial, ck.flatten_tree(params), losses)

    enc = make_encode_fn(bstate.model)
    index = FlatSDC.build(enc(item_emb), 4, device=dev)
    print(f"binary index: {index.nbytes()/2**20:.1f} MiB "
          f"(float: {item_emb.numel() * 4/2**20:.1f} MiB)")

    # ---- serve: user queries -> query tower -> binarize -> SDC top-k ----
    batch = make_batch(999, 32)
    with torch.no_grad():
        q_emb = tt.query_embed(params, batch["hist_ids"], batch["hist_mask"], cfg)
    q_codes = enc(q_emb)
    vals, ids = index.search(q_codes, 100)
    ids = ids.cpu().numpy()

    q_np, item_np = q_emb.cpu().numpy(), item_emb.cpu().numpy()
    float_scores = q_np @ item_np.T
    float_top = np.argsort(-float_scores, -1)[:, :10]

    # retrieval-quality metrics (items within a taste group are
    # near-interchangeable, so exact top-10 identity is noise: what
    # matters is retrieving the right REGION of the catalog):
    gq = batch["pos_items"].cpu().numpy() // items_per_group
    grp_bebr = np.mean([(ids[i, :10] // items_per_group == gq[i]).mean() for i in range(32)])
    grp_float = np.mean([(float_top[i] // items_per_group == gq[i]).mean() for i in range(32)])
    cover = np.mean([len(set(float_top[i].tolist()) & set(ids[i].tolist())) / 10
                     for i in range(32)])
    print(f"top-10 in the user's taste group: float={grp_float:.2f} BEBR={grp_bebr:.2f}")
    print(f"float top-10 covered by BEBR top-100: {cover:.2f}")
    print("done.")
    return {"group_float": float(grp_float), "group_bebr": float(grp_bebr),
            "cover": float(cover), "index": index, "q_codes": q_codes, "training": training}


if __name__ == "__main__":
    main()
