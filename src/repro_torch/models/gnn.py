"""MeshGraphNet (arXiv:2010.03409; ports ``repro/models/gnn.py``):
encode-process-decode GNN.

Message passing in the reference's edge-index -> scatter form: endpoint
features gathered by id, edges updated by an MLP, aggregated back to
nodes. Static shapes throughout (padded edges carry a mask), so the same
code takes full-batch graphs, sampled mini-batches and batched molecules.

Both directions are deterministic on the card, so two runs give the same
bits: the gathers (the reference's ``jnp.take``) are
``embedding.embedding_lookup``, whose backward is ``index_put_`` with
``accumulate=True``, and the sum aggregation (``jax.ops.segment_sum``) is
``embedding.segment_sum``, the same op (a float ``index_add_`` or
``scatter_add_`` sums by atomics in an order that changes from run to
run). The ``max`` aggregator is ``scatter_reduce`` with ``amax``, an
order-free reduction; an empty segment's -inf becomes 0 as in the
reference. ``remat`` checkpoints each layer while gradients are recorded
(``spmd.checkpoint``: on a sharded step its collectives' results are
kept, not run again in the backward pass); ``node_constrain`` (a GSPMD
sharding constraint in the reference) is applied where the reference
applies it, to each layer's aggregate and node states: it redistributes a
DTensor (``parallel/spmd.constrain``) and is an identity on one device.
A parameter tree is the reference's: ``{"node_enc", "edge_enc",
"decoder": [{"w", "b"}, ...], "layers": [{"edge_mlp", "node_mlp"}, ...]}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import full_fp32_matmul, is_dtensor, resolve_device
from repro_torch.models.recsys.embedding import (
    embedding_lookup,
    mlp_apply,
    segment_sum,
    tree_from_numpy,
)
from repro_torch.parallel import spmd

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3
    aggregator: str = "sum"
    remat: bool = True  # rematerialise each message-passing layer
    dtype: Any = torch.float32

    def param_count(self) -> int:
        h = self.d_hidden

        def mlp(i, o):
            return i * h + h + (self.mlp_layers - 2) * (h * h + h) + h * o + o

        enc = mlp(self.d_node_in, h) + mlp(self.d_edge_in, h)
        proc = self.n_layers * (mlp(3 * h, h) + mlp(2 * h, h))
        dec = mlp(h, self.d_out)
        return enc + proc + dec


def _init_mlp(key, d_in, d_h, d_out, n_layers, dtype, device):
    """Layers ``{"w": N(0, 1) / sqrt(d_in), "b": 0}`` of widths d_in, d_h...,
    d_out, layer i from ``split(key, n_layers)[i]``."""
    dims = [d_in] + [d_h] * (n_layers - 1) + [d_out]
    return [
        {
            "w": prng.normal(k, (a, b), div=np.sqrt(np.float32(a)), dtype=dtype, device=device),
            "b": torch.zeros((b,), dtype=dtype, device=device),
        }
        for k, a, b in zip(prng.split(key, len(dims) - 1), dims[:-1], dims[1:])
    ]


def init_params(cfg: GNNConfig, key: torch.Tensor, device="cuda") -> Params:
    """The reference's initialisation from ``key`` (``prng``, on ``device``):
    ``split(key, 4 + 2 L)``, the encoders and decoder from keys 0-2, layer
    i's edge and node MLPs from keys 4 + 2i and 5 + 2i."""
    device = resolve_device(device)
    h, m = cfg.d_hidden, cfg.mlp_layers
    ks = prng.split(key, 4 + cfg.n_layers * 2)

    def mlp(k, d_in, d_out):
        return _init_mlp(k, d_in, h, d_out, m + 1, cfg.dtype, device)

    return {
        "node_enc": mlp(ks[0], cfg.d_node_in, h),
        "edge_enc": mlp(ks[1], cfg.d_edge_in, h),
        "decoder": mlp(ks[2], h, cfg.d_out),
        "layers": [{"edge_mlp": mlp(ks[4 + 2 * i], 3 * h, h),
                    "node_mlp": mlp(ks[5 + 2 * i], 2 * h, h)}
                   for i in range(cfg.n_layers)],
    }


def gnn_from_numpy(params: Params, device="cuda") -> Params:
    """The reference's ``init_params`` tree as numpy arrays -> the same tree
    of tensors, each leaf of its own dtype."""
    return tree_from_numpy(params, None, device)


def segment_max(rows: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """``jax.ops.segment_max``: the largest row of each segment, -inf for an
    empty one (``scatter_reduce`` with ``amax``; its gradient goes to the
    maximal rows, split evenly between ties)."""
    out = torch.full((num_segments,) + tuple(rows.shape[1:]), -torch.inf, dtype=rows.dtype,
                     device=rows.device)
    idx = segment_ids.view(-1, *([1] * (rows.dim() - 1))).expand_as(rows)
    return out.scatter_reduce(0, idx, rows, "amax", include_self=True)


def _endpoints(v, senders, receivers):
    """(v[senders], v[receivers]). On DTensors the two are looked up together,
    [E, 2] ids in one lookup, so a layer's node states move once for both
    (GSPMD gathers them once for the two)."""
    if not is_dtensor(v):
        return embedding_lookup(v, senders), embedding_lookup(v, receivers)
    both = embedding_lookup(v, spmd.stack_alike([senders, receivers]))
    return both[:, 0], both[:, 1]


def _layer(lp, v, e, senders, receivers, edge_mask, n_nodes, aggregator, node_constrain=None):
    # edge update: concat(e, v_s, v_r) -> MLP, residual
    vs, vr = _endpoints(v, senders, receivers)
    e_new = mlp_apply(lp["edge_mlp"], torch.cat([e, vs, vr], dim=-1))
    if edge_mask is not None:
        e_new = e_new * edge_mask[:, None].to(e.dtype)
    e = e + e_new
    # node update: aggregate incoming edges, concat, MLP, residual
    if aggregator == "max":
        agg = segment_max(e, receivers, n_nodes)
        agg = torch.where(torch.isfinite(agg), agg, 0.0)
    else:
        agg = segment_sum(e, receivers, n_nodes)
    if node_constrain is not None:
        agg = node_constrain(agg)
    v = v + mlp_apply(lp["node_mlp"], torch.cat([v, agg], dim=-1))
    if node_constrain is not None:
        v = node_constrain(v)
    return v, e


def forward(params: Params, node_feat, edge_feat, senders, receivers, edge_mask=None,
            cfg: GNNConfig = None, node_constrain=None) -> torch.Tensor:
    """Per-node outputs [N, d_out]. node_feat [N, d_node_in], edge_feat [E,
    d_edge_in], senders/receivers [E] int tensors, edge_mask [E] bool
    (False = padding) or None, all on the parameters' device."""
    full_fp32_matmul()
    senders, receivers = senders.long(), receivers.long()
    n_nodes = node_feat.shape[0]
    v = mlp_apply(params["node_enc"], node_feat)
    e = mlp_apply(params["edge_enc"], edge_feat)
    if edge_mask is not None:
        e = e * edge_mask[:, None].to(e.dtype)
    aggregator = cfg.aggregator if cfg is not None else "sum"
    remat = cfg is not None and cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        args = (lp, v, e, senders, receivers, edge_mask, n_nodes, aggregator, node_constrain)
        v, e = spmd.checkpoint(_layer, *args) if remat else _layer(*args)
    return mlp_apply(params["decoder"], v)


def mse_loss(params, node_feat, edge_feat, senders, receivers, targets, node_mask=None,
             edge_mask=None, cfg: GNNConfig = None, node_constrain=None) -> torch.Tensor:
    out = forward(params, node_feat, edge_feat, senders, receivers, edge_mask=edge_mask,
                  cfg=cfg, node_constrain=node_constrain)
    err = torch.square(out - targets)
    if node_mask is not None:
        err = err * node_mask[:, None].to(err.dtype)
        denom = torch.sum(node_mask.to(torch.int32)) * out.shape[-1]
        return torch.sum(err) / torch.clamp(denom.to(err.dtype), min=1.0)
    return torch.mean(err)
