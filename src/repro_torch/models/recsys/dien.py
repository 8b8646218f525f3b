"""DIEN (arXiv:1809.03672; ports ``repro/models/recsys/dien.py``):
interest extraction GRU + interest evolution AUGRU over user behavior
sequences. Assigned config: embed_dim=18, seq_len=100, gru_dim=108, MLP
200-80, AUGRU interaction.

Both recurrences are Python loops over the sequence where the reference
uses ``lax.scan``: on the card every step is some twenty small launches
(``chip_smoke.py`` counts them). Parameters are the reference's tree
(``dien_from_numpy`` / ``dien_to_numpy``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import full_fp32_matmul, is_dtensor, resolve_device
from repro_torch.models.recsys.dlrm import bce_logits
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
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple = (200, 80)
    item_vocab: int = 500_000
    cate_vocab: int = 5_000
    dtype: Any = torch.float32

    @property
    def beh_dim(self) -> int:
        return 2 * self.embed_dim  # item + category embeddings

    def param_count(self) -> int:
        gru = 3 * (self.beh_dim + self.gru_dim + 1) * self.gru_dim
        augru = 3 * (self.gru_dim + self.gru_dim + 1) * self.gru_dim
        att = (2 * self.gru_dim) * 36 + 36
        mlp_in = self.gru_dim + 2 * self.beh_dim
        dims = (mlp_in,) + self.mlp + (1,)
        mlp = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        emb = (self.item_vocab + self.cate_vocab) * self.embed_dim
        return emb + gru + augru + att + mlp


# The attention logits go through a softmax over the sequence, which a
# shift does not move: the gradient of the attention MLP's last bias is zero
# in exact arithmetic and float32 rounding noise in practice. Each such leaf
# (a ``checkpoint.flatten_tree`` key) maps to the leaf whose gradient sets
# its scale, for comparisons of two computations' gradients.
SHIFT_INVARIANT_LEAVES = {"['att']/[1]/['b']": "['att']/[1]/['w']"}


def _over_sqrt(k, shape, dtype, device):
    """``normal(k, shape) / sqrt(shape[0])``, the divisor rounded to float32."""
    return prng.normal(k, shape, div=np.sqrt(np.float32(shape[0])), dtype=dtype, device=device)


def _init_gru(key, d_in, d_h, dtype, device):
    """Gates r, z, n from ``split(key, 3)``: wx from the gate's key, wh from
    its ``fold_in(k, 1)``, as the reference's."""
    def gate(k):
        return {"wx": _over_sqrt(k, (d_in, d_h), dtype, device),
                "wh": _over_sqrt(prng.fold_in(k, 1), (d_h, d_h), dtype, device),
                "b": torch.zeros((d_h,), dtype=dtype, device=device)}

    ks = prng.split(key, 3)
    return {"r": gate(ks[0]), "z": gate(ks[1]), "n": gate(ks[2])}


def init_params(cfg: DIENConfig, key: torch.Tensor, device="cuda") -> Dict[str, Any]:
    """The reference's initialisation from ``key`` (``prng``, on ``device``):
    ``split(key, 6)``, and ``target_proj`` from ``fold_in`` of the attention
    MLP's key with 7."""
    device = resolve_device(device)
    beh = cfg.beh_dim
    mlp_in = cfg.gru_dim + 2 * beh
    E = cfg.embed_dim
    ks = prng.split(key, 6)
    return {
        "item_table": init_table(ks[0], TableConfig(cfg.item_vocab, E), cfg.dtype, device),
        "cate_table": init_table(ks[1], TableConfig(cfg.cate_vocab, E), cfg.dtype, device),
        "gru": _init_gru(ks[2], beh, cfg.gru_dim, cfg.dtype, device),
        "augru": _init_gru(ks[3], cfg.gru_dim, cfg.gru_dim, cfg.dtype, device),
        "att": mlp_tree(ks[4], (2 * cfg.gru_dim, 36, 1), cfg.dtype, device),
        "mlp": mlp_tree(ks[5], (mlp_in,) + cfg.mlp + (1,), cfg.dtype, device),
        "target_proj": _over_sqrt(prng.fold_in(ks[4], 7), (beh, cfg.gru_dim), cfg.dtype,
                                  device),
    }


def dien_from_numpy(params: Dict[str, Any], cfg: DIENConfig, device="cuda"):
    """The reference's ``init_params`` tree as numpy arrays -> the same tree of tensors."""
    return tree_from_numpy(params, cfg.dtype, device)


def dien_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    return tree_to_numpy(params)


def _gates(p, x, h):
    r = torch.sigmoid(x @ p["r"]["wx"] + h @ p["r"]["wh"] + p["r"]["b"])
    z = torch.sigmoid(x @ p["z"]["wx"] + h @ p["z"]["wh"] + p["z"]["b"])
    n = torch.tanh(x @ p["n"]["wx"] + (r * h) @ p["n"]["wh"] + p["n"]["b"])
    return z, n


def _gru_cell(p, x, h):
    z, n = _gates(p, x, h)
    return (1 - z) * n + z * h


def _augru_cell(p, x, h, att):
    """AUGRU: the attention score scales the update gate."""
    z, n = _gates(p, x, h)
    z = att[:, None] * z
    return (1 - z) * h + z * n


def _behavior_embed(params, item_ids, cate_ids):
    it = embedding_lookup(params["item_table"], item_ids)
    ct = embedding_lookup(params["cate_table"], cate_ids)
    return torch.cat([it, ct], dim=-1)


def _embed(params, hist_items, hist_cates, target_item, target_cate):
    """(the behaviors' embeddings [B, L, 2e], the target's [B, 2e]). On
    DTensors the history and the target are looked up together, [B, L + 1]
    ids a table, so a table's rows move once for both (GSPMD gathers a
    table's rows once for the two lookups)."""
    if not is_dtensor(params["item_table"]):
        return (_behavior_embed(params, hist_items, hist_cates),
                _behavior_embed(params, target_item, target_cate))
    L = hist_items.shape[1]
    both = _behavior_embed(params, torch.cat([hist_items, target_item[:, None]], 1),
                           torch.cat([hist_cates, target_cate[:, None]], 1))
    return both[:, :L], both[:, L]


def _zero_state(mask, width: int):
    """A recurrent state of zeros [B, width] laid out as the batch rows of
    ``mask`` [B, L] (``torch.zeros`` of the whole shape would be a plain
    tensor of every row on each rank of a sharded step)."""
    return torch.zeros_like(mask[:, :1]).expand(-1, width)


def forward(params, hist_items, hist_cates, hist_mask, target_item, target_cate,
            cfg: DIENConfig) -> torch.Tensor:
    """CTR logits [B]. Two stages: a GRU over the behaviors, then an AUGRU
    weighted by target attention."""
    full_fp32_matmul()
    L = hist_items.shape[1]
    beh, tgt = _embed(params, hist_items, hist_cates, target_item, target_cate)
    mask = torch.as_tensor(hist_mask, device=beh.device).to(beh.dtype)

    # Stage 1: interest extraction GRU over time.
    h = _zero_state(mask, cfg.gru_dim)
    states = []
    for t in range(L):
        m = mask[:, t, None]
        h = m * _gru_cell(params["gru"], beh[:, t], h) + (1 - m) * h
        states.append(h)
    states = torch.stack(states, dim=1)  # [B, L, H]

    # Target attention over the extracted interests.
    tgt_h = tgt @ params["target_proj"]  # [B, H]
    att_in = torch.cat([states, tgt_h[:, None, :].expand(states.shape)], dim=-1)
    att = mlp_apply(params["att"], att_in)[..., 0]  # [B, L]
    att = torch.where(mask > 0, att, torch.full_like(att, -1e30))
    att = torch.softmax(att, dim=-1)

    # Stage 2: interest evolution AUGRU.
    h = _zero_state(mask, cfg.gru_dim)
    for t in range(L):
        m = mask[:, t, None]
        h = m * _augru_cell(params["augru"], states[:, t], h, att[:, t]) + (1 - m) * h

    feats = torch.cat([h, tgt, torch.sum(beh * mask[..., None], 1)], dim=-1)
    return mlp_apply(params["mlp"], feats)[:, 0]


def bce_loss(params, hist_items, hist_cates, hist_mask, target_item, target_cate, labels,
             cfg: DIENConfig) -> torch.Tensor:
    logits = forward(params, hist_items, hist_cates, hist_mask, target_item, target_cate, cfg)
    return bce_logits(logits, torch.as_tensor(labels, dtype=logits.dtype, device=logits.device))
