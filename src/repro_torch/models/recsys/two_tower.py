"""Two-tower retrieval (YouTube RecSys'19; ports
``repro/models/recsys/two_tower.py``): query/item MLP towers, dot
similarity, in-batch sampled softmax with logQ correction.

This is the arch most representative of the paper's setting: the item
tower's embeddings are exactly what BEBR binarizes and indexes
(``examples/train_two_tower_e2e_torch.py``). Parameters are the
reference's tree, ``{"user_table", "item_table", "q_tower", "i_tower"}``
of tensors; ``two_tower_from_numpy`` / ``two_tower_to_numpy`` carry it
across. ``_unit`` uses ``rsqrt`` as the reference does (XLA's CPU rsqrt
is not correctly rounded, so the two agree within a tolerance, not bit
for bit).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.device import full_fp32_matmul, is_dtensor, resolve_device
from repro_torch.models.recsys.embedding import (
    TableConfig,
    embedding_bag_fixed,
    embedding_lookup,
    init_table,
    mlp_apply,
    mlp_tree,
    tree_from_numpy,
    tree_to_numpy,
)


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    user_vocab: int = 1_000_000
    item_vocab: int = 1_000_000
    hist_len: int = 32
    dtype: Any = torch.float32

    @property
    def tower_in(self) -> int:
        return self.embed_dim  # bagged history / item id embedding

    def param_count(self) -> int:
        emb = (self.user_vocab + self.item_vocab) * self.embed_dim
        dims = (self.embed_dim,) + self.tower_mlp
        tower = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return emb + 2 * tower


def init_params(cfg: TwoTowerConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """The reference's initialisation drawn from ``generator`` (on ``device``):
    tables N(0, 1) / sqrt(D), tower weights N(0, 1) * sqrt(2 / d_in), biases 0."""
    device = resolve_device(device)
    dims = (cfg.embed_dim,) + cfg.tower_mlp
    return {
        "user_table": init_table(generator, TableConfig(cfg.user_vocab, cfg.embed_dim),
                                 cfg.dtype, device),
        "item_table": init_table(generator, TableConfig(cfg.item_vocab, cfg.embed_dim),
                                 cfg.dtype, device),
        "q_tower": mlp_tree(generator, dims, cfg.dtype, device),
        "i_tower": mlp_tree(generator, dims, cfg.dtype, device),
    }


def two_tower_from_numpy(params: Dict[str, Any], cfg: TwoTowerConfig, device="cuda"):
    """The reference's ``init_params`` tree as numpy arrays -> the same tree of tensors."""
    return tree_from_numpy(params, cfg.dtype, device)


def two_tower_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    return tree_to_numpy(params)


def _unit(x, eps=1e-12):
    return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + eps)


def query_embed(params, hist_ids, hist_mask, cfg) -> torch.Tensor:
    """User history bag -> query tower -> unit embedding [B, out]."""
    bag = embedding_bag_fixed(params["user_table"], hist_ids, hist_mask, "mean")
    return _unit(mlp_apply(params["q_tower"], bag))


def item_embed(params, item_ids, cfg) -> torch.Tensor:
    emb = embedding_lookup(params["item_table"], item_ids)
    return _unit(mlp_apply(params["i_tower"], emb))


def sampled_softmax_loss(params, hist_ids, hist_mask, pos_items, item_logq,
                         cfg: TwoTowerConfig, temperature: float = 0.05) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction (Yi et al. RecSys'19)."""
    full_fp32_matmul()
    q = query_embed(params, hist_ids, hist_mask, cfg)  # [B, D]
    it = item_embed(params, pos_items, cfg)  # [B, D]
    logq = torch.as_tensor(item_logq, device=q.device)

    def score(q, it, logq):
        return (q @ it.T) / temperature - logq[None, :]

    if is_dtensor(q):  # each rank's block of the [B, B] logits (spmd)
        from repro_torch.parallel import spmd

        return -torch.mean(spmd.diagonal_log_softmax(score, q, it, logq))
    return -torch.mean(torch.diagonal(torch.log_softmax(score(q, it, logq), dim=-1)))


def score_candidates(params, hist_ids, hist_mask, cand_ids, cfg) -> torch.Tensor:
    """retrieval_cand serve path: [B_q] queries x [N_c] candidates -> scores
    (the float baseline; the BEBR deployment binarizes the candidates,
    ``train/steps.tt_retrieval_bebr_step``)."""
    full_fp32_matmul()
    q = query_embed(params, hist_ids, hist_mask, cfg)
    it = item_embed(params, cand_ids, cfg)
    return q @ it.T
