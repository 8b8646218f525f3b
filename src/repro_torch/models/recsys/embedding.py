"""Embedding tables and MLPs for the recsys models (ports the parts of
``repro/models/recsys/embedding.py`` that DLRM serving uses).

Tables are plain [V, D] tensors and one-hot fields are a row lookup. An
MLP is a list of layers, each a ``{"w": [d_in, d_out], "b": [d_out]}``
mapping (an ``nn.ParameterDict`` inside a model), applied as the
reference does, ``x @ w + b``: product, then bias, in full float32.
Multi-hot bags (``embedding_bag*``, with ``TableConfig.combiner``), the
MLP's ``final_act`` and ``hash_bucket`` come with the two-tower and MIND
slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from repro_torch.device import full_fp32_matmul, resolve_device


@dataclasses.dataclass(frozen=True)
class TableConfig:
    vocab: int
    dim: int


def init_table(generator: torch.Generator, cfg: TableConfig, dtype=torch.float32,
               device="cuda", out: torch.Tensor | None = None) -> torch.Tensor:
    """A [vocab, dim] table ~ N(0, 1) / sqrt(dim), drawn from ``generator``
    (which lives on ``device``); written into ``out`` when given."""
    if out is None:
        out = torch.empty((cfg.vocab, cfg.dim), dtype=dtype, device=resolve_device(device))
    with torch.no_grad():
        out.normal_(generator=generator).mul_(1.0 / math.sqrt(cfg.dim))
    return out


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One-hot field lookup: ids [...] -> [..., dim]."""
    return table[ids.long()]


def mlp_params(generator: torch.Generator, dims: Sequence[int], dtype=torch.float32,
               device="cuda") -> nn.ModuleList:
    """Layers ``{"w": N(0, 1) * sqrt(2 / d_in) [d_in, d_out], "b": 0 [d_out]}``."""
    device = resolve_device(device)
    layers = nn.ModuleList()
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, device=device) * math.sqrt(2.0 / a)
        layers.append(nn.ParameterDict({
            "w": nn.Parameter(w.to(dtype)),
            "b": nn.Parameter(torch.zeros((b,), dtype=dtype, device=device)),
        }))
    return layers


def mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` per layer, ReLU between layers (none after the last)."""
    full_fp32_matmul()
    for i, layer in enumerate(layers):
        x = torch.matmul(x, layer["w"]) + layer["b"]
        if i + 1 < len(layers):
            x = torch.relu(x)
    return x
