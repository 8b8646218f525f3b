"""MIND (arXiv:1904.08030; ports ``repro/models/recsys/mind.py``):
multi-interest network with dynamic (capsule) routing for retrieval.
embed_dim=64, 4 interest capsules, 3 routing iterations, label-aware
attention for training.

The routing iterations are a Python loop where the reference uses
``lax.scan``. Parameters are the reference's tree, ``{"item_table", "S",
"H"}`` of tensors (``mind_from_numpy`` / ``mind_to_numpy``). ``_squash``
uses ``rsqrt`` as the reference does, so the two agree within a
tolerance (XLA's CPU rsqrt is not correctly rounded).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.device import full_fp32_matmul, resolve_device
from repro_torch.models.recsys.embedding import (
    TableConfig,
    embedding_lookup,
    init_table,
    mlp_apply,
    mlp_tree,
    tree_from_numpy,
    tree_to_numpy,
)


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    item_vocab: int = 1_000_000
    hist_len: int = 50
    label_pow: float = 2.0  # label-aware attention sharpness
    dtype: Any = torch.float32

    def param_count(self) -> int:
        return (
            self.item_vocab * self.embed_dim
            + self.embed_dim * self.embed_dim  # bilinear routing map S
            + 2 * (self.embed_dim * self.embed_dim + self.embed_dim)  # H-layer
        )


def init_params(cfg: MINDConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """The reference's initialisation drawn from ``generator`` (on ``device``)."""
    device = resolve_device(device)
    D = cfg.embed_dim
    S = torch.randn((D, D), generator=generator, device=device) / math.sqrt(D)
    return {
        "item_table": init_table(generator, TableConfig(cfg.item_vocab, D), cfg.dtype, device),
        "S": S.to(cfg.dtype),
        "H": mlp_tree(generator, (D, D, D), cfg.dtype, device),
    }


def mind_from_numpy(params: Dict[str, Any], cfg: MINDConfig, device="cuda"):
    """The reference's ``init_params`` tree as numpy arrays -> the same tree of tensors."""
    return tree_from_numpy(params, cfg.dtype, device)


def mind_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    return tree_to_numpy(params)


def _squash(x, dim=-1, eps=1e-9):
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x * torch.rsqrt(n2 + eps)


def interest_capsules(params, hist_ids, hist_mask, cfg: MINDConfig,
                      routing_logits_init=None) -> torch.Tensor:
    """B2I dynamic routing: [B, L] history -> [B, K, D] interest capsules.

    Routing logits start at zero (or ``routing_logits_init`` [B, K, L]) and
    are iterated ``capsule_iters`` times with the squash nonlinearity.
    """
    full_fp32_matmul()
    table = params["item_table"]
    beh = embedding_lookup(table, hist_ids)  # [B, L, D]
    beh_mapped = beh @ params["S"]  # bilinear map
    mask = torch.as_tensor(hist_mask, device=table.device).to(beh.dtype)  # [B, L]
    if routing_logits_init is None:
        # zeros laid out as the batch rows (a whole-shape torch.zeros would be
        # a plain tensor of every row on each rank of a sharded step)
        blog = torch.zeros_like(mask[:, None, :]).expand(-1, cfg.n_interests, -1)
    else:
        blog = torch.as_tensor(routing_logits_init, dtype=beh.dtype, device=beh.device)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(blog, dim=1)  # over capsules
        w = w * mask[:, None, :]
        caps = _squash(torch.einsum("bkl,bld->bkd", w, beh_mapped))
        blog = blog + torch.einsum("bkd,bld->bkl", caps, beh_mapped)
    # H-layer (two-layer ReLU MLP) on each capsule
    return mlp_apply(params["H"], caps)


def label_aware_loss(params, hist_ids, hist_mask, pos_items, neg_items,
                     cfg: MINDConfig) -> torch.Tensor:
    """Sampled softmax with label-aware attention over interests."""
    caps = interest_capsules(params, hist_ids, hist_mask, cfg)  # [B, K, D]
    pos = embedding_lookup(params["item_table"], pos_items)  # [B, D]
    neg = embedding_lookup(params["item_table"], neg_items)  # [B, Nn, D]
    att = torch.softmax(cfg.label_pow * torch.einsum("bkd,bd->bk", caps, pos), dim=-1)
    user = torch.einsum("bk,bkd->bd", att, caps)  # [B, D]
    pos_logit = torch.sum(user * pos, -1, keepdim=True)
    neg_logit = torch.einsum("bd,bnd->bn", user, neg)
    logits = torch.cat([pos_logit, neg_logit], dim=-1)
    return -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])


def serve_interests(params, hist_ids, hist_mask, cfg: MINDConfig) -> torch.Tensor:
    """Serving: K interest embeddings per user (each queries the index)."""
    return interest_capsules(params, hist_ids, hist_mask, cfg)
