"""DLRM-RM2 (arXiv:1906.00091), serving and training (ports
``repro/models/recsys/dlrm.py``): bottom MLP + embedding lookups + dot
interaction + top MLP.

The interaction goes through ``kernels.dot_interact.ops.dot_interaction``:
on the card that is the hand-written CUDA kernel, on the CPU its plain
version, inside a ``torch.autograd.Function`` whose backward is plain
torch. (The reference's own forward calls ``dot_interact_ref``; its
Pallas kernel is meant for the accelerator.) The concat orders are the
reference's: ``[x, emb]`` for the features and ``[inter, x]`` for the
top MLP's input. The 26 tables are one stacked [F, V, D] tensor.

``forward`` and ``bce_loss`` take the reference's parameter tree
(``{"tables", "bot", "top"}`` of tensors), and so do the train and serve
steps (``train/steps.py``); the ``DLRM`` module holds the same tensors as
parameters (``DLRM.tree`` / ``DLRM.from_tree`` share their storage), for
callers that want a module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.dot_interact.ops import dot_interaction
from repro_torch.models.recsys.embedding import (
    TableConfig,
    init_table,
    mlp_apply,
    mlp_params,
    stacked_lookup,
    tree_from_numpy,
    tree_to_numpy,
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
        self.cfg = cfg
        self.tables = nn.Parameter(tables)
        self.bot = bot
        self.top = top

    def tree(self) -> Dict[str, Any]:
        """The reference's parameter tree of this module's parameters (shared storage)."""
        return {"tables": self.tables, "bot": _layer_tree(self.bot), "top": _layer_tree(self.top)}

    @staticmethod
    def from_tree(tree: Dict[str, Any], cfg: DLRMConfig) -> "DLRM":
        """A DLRM over the tensors of ``tree`` (shared storage, no copy)."""
        check_tree(tree, cfg)
        return DLRM(cfg, tree["tables"], _layer_module(tree["bot"]), _layer_module(tree["top"]))

    def features(self, dense, sparse_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x [B, D] the bottom MLP's output, feats [B, n_sparse + 1, D])."""
        return features(self.tree(), dense, sparse_ids, self.cfg)

    def top_logits(self, inter: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return top_logits(self.tree(), inter, x)

    def forward(self, dense, sparse_ids, interact_fn=None) -> torch.Tensor:
        """dense [B, n_dense] f32; sparse_ids [B, n_sparse] int -> logits [B]."""
        return forward(self.tree(), dense, sparse_ids, self.cfg, interact_fn)


def _layer_tree(layers) -> list:
    return [{"w": layer["w"], "b": layer["b"]} for layer in layers]


def _layer_module(tree: list) -> nn.ModuleList:
    return nn.ModuleList(nn.ParameterDict({"w": nn.Parameter(p["w"]), "b": nn.Parameter(p["b"])})
                         for p in tree)


def check_tree(tree: Dict[str, Any], cfg: DLRMConfig) -> None:
    """Raise ValueError unless ``tree``'s tables and MLP layers have ``cfg``'s shapes."""
    want = (cfg.n_sparse, cfg.table_vocab, cfg.embed_dim)
    if tuple(tree["tables"].shape) != want:
        raise ValueError(f"tables {tuple(tree['tables'].shape)} != {want} ({cfg.name})")
    for part, dims in (("bot", cfg.bot_mlp), ("top", cfg.top_dims)):
        if len(tree[part]) != len(dims) - 1:
            raise ValueError(f"{len(tree[part])} {part} layers do not match dims {dims}")
        for p, a, b in zip(tree[part], dims[:-1], dims[1:]):
            w, bias = p["w"], p["b"]
            if tuple(w.shape) != (a, b) or tuple(bias.shape) != (b,):
                raise ValueError(f"layer {tuple(w.shape)} / {tuple(bias.shape)} != ({a}, {b})")


def features(params, dense, sparse_ids, cfg: DLRMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x [B, D] the bottom MLP's output, feats [B, n_sparse + 1, D])."""
    tables = params["tables"]
    dev = tables.device
    dense = torch.as_tensor(dense, dtype=cfg.dtype, device=dev)
    ids = torch.as_tensor(sparse_ids, device=dev).long()
    x = mlp_apply(params["bot"], dense)
    emb = stacked_lookup(tables, ids)  # [B, F, D]: field f from table f
    return x, torch.cat([x[:, None, :], emb], dim=1)


def top_logits(params, inter: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mlp_apply(params["top"], torch.cat([inter, x], dim=-1))[:, 0]


def forward(params, dense, sparse_ids, cfg: DLRMConfig, interact_fn=None) -> torch.Tensor:
    """dense [B, n_dense] f32; sparse_ids [B, n_sparse] int -> logits [B]."""
    x, feats = features(params, dense, sparse_ids, cfg)
    return top_logits(params, (interact_fn or dot_interaction)(feats), x)


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's binary cross-entropy on logits,
    mean(max(l, 0) - l y + log1p(exp(-|l|))), in its op order."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(params, dense, sparse_ids, labels, cfg: DLRMConfig,
             interact_fn=None) -> torch.Tensor:
    logits = forward(params, dense, sparse_ids, cfg, interact_fn=interact_fn)
    return bce_logits(logits, torch.as_tensor(labels, dtype=logits.dtype, device=logits.device))


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

    return DLRM.from_tree(tree_from_numpy(params, cfg.dtype, device), cfg).eval()


def dlrm_to_numpy(model_or_tree) -> Dict[str, Any]:
    """A DLRM (or its parameter tree) as the reference's tree of numpy arrays."""
    tree = model_or_tree.tree() if isinstance(model_or_tree, DLRM) else model_or_tree
    return tree_to_numpy(tree)
