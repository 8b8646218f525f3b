"""Synthetic data (ports ``repro/data/synthetic.py``: ``clustered_corpus``,
``upgraded_corpus``, ``backbone_upgrade``, ``pair_batches`` and
the model zoo's train batches ``lm_batch``, ``gnn_batch``, ``dlrm_batch``,
``tt_batch``, ``mind_batch`` and ``dien_batch``).

``clustered_corpus``, ``upgraded_corpus`` (paired old/new-backbone
corpora), ``backbone_upgrade`` (a drifted float space) and
``pair_batches`` (the binarizer's training pairs) are the reference's
numpy generators, verbatim, so the same seed gives the same arrays bit
for bit. ``clustered_corpus_torch`` (the port's own, with no counterpart
in the reference) follows the same recipe with a ``torch.Generator`` on
the card, for corpora whose float64 numpy intermediates would not fit in
host memory (ten million 256-dim documents); its numbers differ from the
numpy ones.

The model batches are the reference's: drawn from ``fold_in(key(20230713
+ family), step)`` (``prng``) with its splits and draws, so a step gives
the reference's batch on either device, every time (what makes a resumed
run repeat the unbroken one). Integer leaves are equal to the
reference's; float ones carry ``prng.normal``'s bound.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device


def clustered_corpus(
    seed: int,
    n_docs: int,
    n_queries: int,
    dim: int,
    n_clusters: int = 64,
    noise: float = 0.25,
    query_noise: float = 0.15,
    spectrum: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic EBR corpus with cluster structure + query/doc positives.

    Returns (doc_emb [N, dim], query_emb [Q, dim], gt [Q] index of the
    positive doc for each query). Queries are noisy views of their
    positive document. ``spectrum`` > 0 applies a decaying per-axis scale
    followed by a random rotation.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n_docs)
    docs = centers[assign] + noise * rng.normal(size=(n_docs, dim)).astype(np.float32)
    gt = rng.choice(n_docs, size=n_queries, replace=False)
    queries = docs[gt] + query_noise * rng.normal(size=(n_queries, dim)).astype(np.float32)
    if spectrum > 0:
        scales = (1.0 / (1.0 + np.arange(dim)) ** spectrum).astype(np.float32)
        rot, _ = np.linalg.qr(rng.normal(size=(dim, dim)).astype(np.float32))
        docs = (docs * scales) @ rot
        queries = (queries * scales) @ rot
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True) + 1e-12
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True) + 1e-12
    return docs, queries, gt


def upgraded_corpus(
    seed: int,
    n_docs: int,
    n_queries: int,
    dim: int,
    n_clusters: int = 96,
    old_noise: float = 0.30,
    new_noise: float = 0.15,
    old_qnoise: float = 0.25,
    new_qnoise: float = 0.12,
    drift: float = 0.3,
    nonlinear: float = 0.3,
):
    """Paired corpora for backbone-upgrade experiments: the same items
    embedded by an OLD backbone (noisier) and a NEW backbone (cleaner,
    drifted space). Mirrors the paper's Table 4 setting where the upgraded
    model is strictly better, so compatible training can EXCEED the
    (old, old) baseline.

    Returns (old_docs, old_queries, new_docs, new_queries, gt).
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n_docs)
    item_id = rng.normal(size=(n_docs, dim)).astype(np.float32)

    def unit(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)

    # intrinsic item identity is shared; noise level models encoder quality
    old_raw = centers[assign] + old_noise * item_id
    new_raw = centers[assign] + new_noise * item_id

    gt = rng.choice(n_docs, size=n_queries, replace=False)
    qnoise_dir = rng.normal(size=(n_queries, dim)).astype(np.float32)

    old_docs = unit(old_raw)
    new_base = unit(new_raw)
    old_queries = unit(old_raw[gt] + old_qnoise * qnoise_dir)
    new_queries_base = unit(new_raw[gt] + new_qnoise * qnoise_dir)

    # the new backbone lives in a drifted space
    G = rng.normal(size=(dim, dim)).astype(np.float32) / np.sqrt(dim)
    A = rng.normal(size=(dim, dim)).astype(np.float32) / np.sqrt(dim)
    B = rng.normal(size=(dim, dim)).astype(np.float32) / np.sqrt(dim)

    def to_new_space(e):
        out = e + drift * e @ G + nonlinear * np.tanh(e @ A) @ B
        return out / (np.linalg.norm(out, axis=-1, keepdims=True) + 1e-12)

    return (old_docs, old_queries, to_new_space(new_base),
            to_new_space(new_queries_base), gt)


def backbone_upgrade(
    emb: np.ndarray, seed: int, *, strength: float = 0.4,
    nonlinear: float = 0.15,
) -> np.ndarray:
    """Simulate a backbone model upgrade: the new float space is a
    near-identity linear drift of the old one plus a small nonlinear
    component (what a finetuned v2 encoder looks like relative to v1 —
    strongly correlated, not identical, not linearly reachable)."""
    rng = np.random.default_rng(seed)
    d = emb.shape[-1]
    G = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)
    A = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)
    B = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)
    out = emb + strength * emb @ G + nonlinear * np.tanh(emb @ A) @ B
    return out / (np.linalg.norm(out, axis=-1, keepdims=True) + 1e-12)


def pair_batches(
    docs: np.ndarray, seed: int, batch: int, noise: float = 0.1, device="cuda"
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Infinite generator of (anchor, positive) float-embedding pairs for
    emb2emb binarizer training (two noisy views of a sampled doc), drawn
    in numpy and handed over as float32 tensors on ``device`` (as the
    reference's ``jnp.asarray`` rounds them)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n, d = docs.shape
    while True:
        idx = rng.integers(0, n, batch)
        base = docs[idx]
        a = base + noise * rng.normal(size=(batch, d)).astype(np.float32)
        p = base + noise * rng.normal(size=(batch, d)).astype(np.float32)
        yield (torch.from_numpy(a).to(dev, torch.float32),
               torch.from_numpy(p).to(dev, torch.float32))


def clustered_corpus_torch(
    seed: int,
    n_docs: int,
    n_queries: int,
    dim: int,
    n_clusters: int = 64,
    noise: float = 0.25,
    query_noise: float = 0.15,
    device="cuda",
    chunk: int = 1 << 20,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``clustered_corpus``'s recipe (isotropic) drawn on ``device``.

    Returns (docs [N, dim] f32, queries [Q, dim] f32, gt [Q] int64), all
    unit-norm rows, made ``chunk`` documents at a time so that only the
    float corpus itself is resident.
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn(n_clusters, dim, generator=g, device=dev)
    docs = torch.empty(n_docs, dim, device=dev)
    for s in range(0, n_docs, chunk):
        e = min(n_docs, s + chunk)
        assign = torch.randint(0, n_clusters, (e - s,), generator=g, device=dev)
        docs[s:e] = centers[assign] + noise * torch.randn(e - s, dim, generator=g, device=dev)
    gt = torch.randperm(n_docs, generator=g, device=dev)[:n_queries]
    queries = docs[gt] + query_noise * torch.randn(n_queries, dim, generator=g, device=dev)
    for s in range(0, n_docs, chunk):
        blk = docs[s:s + chunk]
        blk /= torch.linalg.vector_norm(blk, dim=-1, keepdim=True) + 1e-12
    queries /= torch.linalg.vector_norm(queries, dim=-1, keepdim=True) + 1e-12
    return docs, queries, gt


def _key(step: int, salt: int, device) -> torch.Tensor:
    """The reference's ``_key(step, salt)``: ``fold_in(key(20230713 + salt), step)``."""
    return prng.fold_in(prng.key(20230713 + salt, device), step)


def _ids(k, high: int, shape) -> torch.Tensor:
    return prng.randint(k, shape, 0, high)


def lm_batch(step: int, batch: int, seq: int, vocab: int,
             device="cuda") -> Dict[str, torch.Tensor]:
    """An LM batch: ``seq + 1`` int32 tokens a row uniform in [0, vocab),
    split into tokens [B, seq] and the next-token labels [B, seq]."""
    tokens = _ids(_key(step, 0, resolve_device(device)), vocab, (batch, seq + 1))
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def gnn_batch(step: int, n_nodes: int, n_edges: int, cfg,
              device="cuda") -> Dict[str, torch.Tensor]:
    """A graph batch: node_feat [N, d_node_in], edge_feat [E, d_edge_in] and
    targets [N, d_out] ~ N(0, 1), senders/receivers [E] int32 uniform over
    the nodes, edge_mask all True."""
    dev = resolve_device(device)
    ks = prng.split(_key(step, 1, dev), 5)
    return {
        "node_feat": prng.normal(ks[0], (n_nodes, cfg.d_node_in)),
        "edge_feat": prng.normal(ks[1], (n_edges, cfg.d_edge_in)),
        "senders": _ids(ks[2], n_nodes, (n_edges,)),
        "receivers": _ids(ks[3], n_nodes, (n_edges,)),
        "edge_mask": torch.ones((n_edges,), dtype=torch.bool, device=dev),
        "targets": prng.normal(ks[4], (n_nodes, cfg.d_out)),
    }


def dlrm_batch(step: int, batch: int, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """A DLRM batch on ``device``: dense [B, n_dense] ~ N(0, 1), sparse_ids
    [B, n_sparse] int32 uniform in [0, table_vocab), labels [B] f32 ~
    Bernoulli(0.25)."""
    ks = prng.split(_key(step, 2, resolve_device(device)), 3)
    return {
        "dense": prng.normal(ks[0], (batch, cfg.n_dense)),
        "sparse_ids": _ids(ks[1], cfg.table_vocab, (batch, cfg.n_sparse)),
        "labels": prng.bernoulli(ks[2], 0.25, (batch,)).to(torch.float32),
    }


def tt_batch(step: int, batch: int, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """A two-tower batch: hist_ids [B, hist_len] and pos_items [B] int32
    uniform over the vocabularies, hist_mask ones, item_logq zeros."""
    dev = resolve_device(device)
    ks = prng.split(_key(step, 3, dev), 3)
    return {
        "hist_ids": _ids(ks[0], cfg.user_vocab, (batch, cfg.hist_len)),
        "hist_mask": torch.ones((batch, cfg.hist_len), device=dev),
        "pos_items": _ids(ks[1], cfg.item_vocab, (batch,)),
        "item_logq": torch.zeros((batch,), device=dev),
    }


def mind_batch(step: int, batch: int, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """A MIND batch: hist_ids [B, hist_len], pos_items [B], neg_items [B, 8]
    int32 uniform over the vocabulary, hist_mask ones."""
    dev = resolve_device(device)
    ks = prng.split(_key(step, 4, dev), 3)
    return {
        "hist_ids": _ids(ks[0], cfg.item_vocab, (batch, cfg.hist_len)),
        "hist_mask": torch.ones((batch, cfg.hist_len), device=dev),
        "pos_items": _ids(ks[1], cfg.item_vocab, (batch,)),
        "neg_items": _ids(ks[2], cfg.item_vocab, (batch, 8)),
    }


def dien_batch(step: int, batch: int, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """A DIEN batch: item and category histories [B, seq_len] and targets
    [B] int32 uniform over the vocabularies, hist_mask ones, labels [B] f32
    ~ Bernoulli(0.3)."""
    dev = resolve_device(device)
    ks = prng.split(_key(step, 5, dev), 5)
    return {
        "hist_items": _ids(ks[0], cfg.item_vocab, (batch, cfg.seq_len)),
        "hist_cates": _ids(ks[1], cfg.cate_vocab, (batch, cfg.seq_len)),
        "hist_mask": torch.ones((batch, cfg.seq_len), device=dev),
        "target_item": _ids(ks[2], cfg.item_vocab, (batch,)),
        "target_cate": _ids(ks[3], cfg.cate_vocab, (batch,)),
        "labels": prng.bernoulli(ks[4], 0.3, (batch,)).to(torch.float32),
    }
