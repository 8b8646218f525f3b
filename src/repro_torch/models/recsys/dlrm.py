"""DLRM-RM2 (arXiv:1906.00091), the serving forward (ports
``repro/models/recsys/dlrm.py``): bottom MLP + embedding lookups + dot
interaction + top MLP.

The interaction goes through ``kernels.dot_interact.ops.dot_interaction``:
on the card that is the hand-written CUDA kernel, on the CPU its plain
version. (The reference's own forward calls ``dot_interact_ref``; its
Pallas kernel is meant for the accelerator.) The concat orders are the
reference's: ``[x, emb]`` for the features and ``[inter, x]`` for the
top MLP's input. The 26 tables are one stacked [F, V, D] tensor.

Training (``bce_loss`` and a backward through the interaction) comes with
the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.dot_interact.ops import dot_interaction
from repro_torch.models.recsys.embedding import (
    TableConfig,
    embedding_lookup,
    init_table,
    mlp_apply,
    mlp_params,
)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp_hidden: Tuple[int, ...] = (512, 512, 256, 1)
    table_vocab: int = 1_000_000
    dtype: Any = torch.float32

    @property
    def n_feat(self) -> int:
        return self.n_sparse + 1  # +1 bottom-MLP output as a feature

    @property
    def interact_dim(self) -> int:
        return self.n_feat * (self.n_feat - 1) // 2 + self.embed_dim

    @property
    def top_dims(self) -> Tuple[int, ...]:
        return (self.interact_dim,) + self.top_mlp_hidden

    def param_count(self) -> int:
        emb = self.n_sparse * self.table_vocab * self.embed_dim
        bot = sum(a * b + b for a, b in zip(self.bot_mlp[:-1], self.bot_mlp[1:]))
        top = sum(a * b + b for a, b in zip(self.top_dims[:-1], self.top_dims[1:]))
        return emb + bot + top


class DLRM(nn.Module):
    """``tables`` [n_sparse, vocab, embed_dim]; ``bot``/``top``: MLP layers
    ``{"w": [d_in, d_out], "b": [d_out]}`` (the reference's layout)."""

    def __init__(self, cfg: DLRMConfig, tables: torch.Tensor, bot: nn.ModuleList,
                 top: nn.ModuleList):
        super().__init__()
        want = (cfg.n_sparse, cfg.table_vocab, cfg.embed_dim)
        if tuple(tables.shape) != want:
            raise ValueError(f"tables {tuple(tables.shape)} != {want}")
        self.cfg = cfg
        self.tables = nn.Parameter(tables)
        self.bot = bot
        self.top = top

    def features(self, dense, sparse_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x [B, D] the bottom MLP's output, feats [B, n_sparse + 1, D])."""
        dev = self.tables.device
        dense = torch.as_tensor(dense, dtype=self.cfg.dtype, device=dev)
        ids = torch.as_tensor(sparse_ids, device=dev).long()
        x = mlp_apply(self.bot, dense)
        F, V, D = self.tables.shape
        rows = ids + torch.arange(F, device=dev) * V  # field f's table starts at row f * V
        emb = embedding_lookup(self.tables.reshape(F * V, D), rows)  # [B, F, D]
        return x, torch.cat([x[:, None, :], emb], dim=1)

    def top_logits(self, inter: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.top, torch.cat([inter, x], dim=-1))[:, 0]

    def forward(self, dense, sparse_ids, interact_fn=None) -> torch.Tensor:
        """dense [B, n_dense] f32; sparse_ids [B, n_sparse] int -> logits [B]."""
        x, feats = self.features(dense, sparse_ids)
        return self.top_logits((interact_fn or dot_interaction)(feats), x)


def init_dlrm(cfg: DLRMConfig, generator: torch.Generator, device="cuda") -> DLRM:
    """A DLRM with the reference's initialisation, drawn from ``generator``
    (on ``device``): tables N(0, 1) / sqrt(D), MLP weights N(0, 1) *
    sqrt(2 / d_in), biases 0. The reference draws from ``jax.random``, so
    the numbers differ; ``dlrm_from_numpy`` carries its weights over."""
    device = resolve_device(device)
    tables = torch.empty((cfg.n_sparse, cfg.table_vocab, cfg.embed_dim), dtype=cfg.dtype,
                         device=device)
    for f in range(cfg.n_sparse):
        init_table(generator, TableConfig(cfg.table_vocab, cfg.embed_dim), out=tables[f])
    bot = mlp_params(generator, cfg.bot_mlp, cfg.dtype, device)
    top = mlp_params(generator, cfg.top_dims, cfg.dtype, device)
    return DLRM(cfg, tables, bot, top).eval()


def dlrm_from_numpy(params: Dict[str, Any], cfg: DLRMConfig, device="cuda") -> DLRM:
    """The reference's ``init_params`` tree as numpy arrays -> a DLRM on ``device``.

    ``params = {"tables": [F, V, D], "bot": [{"w": [d_in, d_out], "b"}, ...],
    "top": [...]}``; the layout is kept, so the weights carry over exactly.
    """
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.array(a), dtype=cfg.dtype, device=device)

    def layers(ps, dims):
        if len(ps) != len(dims) - 1:
            raise ValueError(f"{len(ps)} layers do not match dims {dims}")
        out = nn.ModuleList()
        for p, a, b in zip(ps, dims[:-1], dims[1:]):
            w, bias = t(p["w"]), t(p["b"])
            if tuple(w.shape) != (a, b) or tuple(bias.shape) != (b,):
                raise ValueError(f"layer {tuple(w.shape)} / {tuple(bias.shape)} != ({a}, {b})")
            out.append(nn.ParameterDict({"w": nn.Parameter(w), "b": nn.Parameter(bias)}))
        return out

    return DLRM(cfg, t(params["tables"]), layers(params["bot"], cfg.bot_mlp),
                layers(params["top"], cfg.top_dims)).eval()
