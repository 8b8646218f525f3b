"""Embedding tables, bags and MLPs for the recsys models (ports
``repro/models/recsys/embedding.py``).

Tables are plain [V, D] tensors and one-hot fields are a row lookup
(``embedding_lookup``). Multi-hot bags are a lookup and a segment sum
(``embedding_bag``, ragged) or a masked sum over a fixed width
(``embedding_bag_fixed``), each with the ``sum`` or ``mean`` combiner. An
MLP is a list of layers, each ``{"w": [d_in, d_out], "b": [d_out]}`` (an
``nn.ParameterDict`` inside the DLRM module, a plain dictionary in a
parameter tree), applied as the reference does, ``x @ w + b``: product,
then bias, in full float32. A parameter tree is the reference's pytree
layout in plain dictionaries and lists of tensors (``tree_from_numpy`` /
``tree_to_numpy`` carry it across as numpy arrays).

The gradient of a lookup is pinned to one form, ``index_put_`` with
``accumulate=True`` into zeros (``embedding_lookup``): on the card that op
sorts the ids and sums each id's rows in their order, so two runs give
the same bits (``index_add_`` and ``index_select``'s own backward sum by
atomics, in an order that changes from run to run). Segment sums in the
forward take the same op. ``hash_bucket`` computes the reference's
uint32 hash in int64 masked to 32 bits (torch's uint32 arithmetic is
incomplete on both devices).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import prng
from repro_torch.device import full_fp32_matmul, is_dtensor, resolve_device


@dataclasses.dataclass(frozen=True)
class TableConfig:
    vocab: int
    dim: int
    combiner: str = "sum"  # sum | mean


def init_table(key: torch.Tensor, cfg: TableConfig, dtype=torch.float32,
               device="cuda", out: torch.Tensor | None = None) -> torch.Tensor:
    """A [vocab, dim] table ``normal(key) * (1 / sqrt(dim))`` in float32, cast
    to ``dtype`` (the reference's draw), on ``device``; drawn a chunk at a
    time into ``out`` when given."""
    scale = np.float32(1.0) / np.sqrt(np.float32(cfg.dim))
    if out is None:
        out = torch.empty((cfg.vocab, cfg.dim), dtype=dtype, device=resolve_device(device))
    with torch.no_grad():
        return prng.normal(key, (cfg.vocab, cfg.dim), mul=scale, out=out)


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` (one index tensor a leading dim of ``table``, all
    broadcast together) whose backward is ``index_put_(accumulate=True)``."""

    @staticmethod
    def forward(ctx, table, *idx):
        ctx.shape = table.shape
        ctx.save_for_backward(*idx)
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx = torch.broadcast_tensors(*ctx.saved_tensors)
        out = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        out.index_put_(tuple(i.reshape(-1) for i in idx), grad.reshape(-1, ctx.shape[-1]),
                       accumulate=True)
        return (out,) + (None,) * len(idx)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One-hot field lookup (the reference's ``jnp.take``): rows of ``table``
    [V, D] at ``ids`` [...] -> [..., D], with the deterministic gradient
    described in the module's docstring. A DTensor table (a sharded step,
    ``parallel/spmd.py``) is looked up where its rows lie
    (``spmd.sharded_take``)."""
    if is_dtensor(table):
        from repro_torch.parallel import spmd

        return spmd.sharded_take(table, ids)
    return _GatherRows.apply(table, torch.as_tensor(ids, device=table.device).long())


def stacked_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The reference's ``vmap`` of ``embedding_lookup`` over the table axis:
    field f of ``ids`` [..., F] looked up in table f of ``tables`` [F, V, D]
    -> [..., F, D], with the same deterministic gradient. A DTensor's tables
    are looked up where their rows lie (``spmd.sharded_take``), with no
    view that flattens the split row dim into the table axis."""
    if is_dtensor(tables):
        from repro_torch.parallel import spmd

        return spmd.sharded_take(tables, ids)
    ids = torch.as_tensor(ids, device=tables.device).long()
    return _GatherRows.apply(tables, torch.arange(tables.shape[0], device=tables.device), ids)


def segment_sum(rows: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """``jax.ops.segment_sum``: rows [n, ...] summed into [num_segments,
    ...] by ``segment_ids`` [n] (int64), through ``index_put`` with
    ``accumulate=True``, each segment's rows in their order (deterministic
    on the card, see the module's docstring). DTensor rows are summed where
    they lie (``spmd.sharded_segment_sum``)."""
    if is_dtensor(rows):
        from repro_torch.parallel import spmd

        return spmd.sharded_segment_sum(rows, segment_ids, num_segments)
    out = torch.zeros((num_segments,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_put((segment_ids,), rows, accumulate=True)


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    segment_ids: torch.Tensor,
    num_bags: int,
    *,
    weights: Optional[torch.Tensor] = None,
    combiner: str = "sum",
) -> torch.Tensor:
    """Ragged multi-hot bag lookup (torch EmbeddingBag equivalent).

    ``table`` [V, D]; ``ids`` [total] indices across all bags;
    ``segment_ids`` [total] the bag of each index (unsorted is fine);
    ``weights`` optional [total] per-sample weights -> [num_bags, D].
    """
    rows = embedding_lookup(table, ids)  # [total, D]
    if weights is not None:
        rows = rows * torch.as_tensor(weights, device=table.device)[:, None]
    seg = torch.as_tensor(segment_ids, device=table.device).long()
    summed = segment_sum(rows, seg, num_bags)
    if combiner == "mean":
        counts = segment_sum(torch.ones(seg.shape, dtype=table.dtype, device=table.device),
                              seg, num_bags)
        summed = summed / torch.clamp(counts, min=1.0)[:, None]
    return summed


def embedding_bag_fixed(table: torch.Tensor, ids: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        combiner: str = "sum") -> torch.Tensor:
    """Fixed-width bags: ids [B, L] -> [B, D]; padded slots carry mask = 0.

    The L slots are summed one at a time in order, as XLA's CPU reduction
    sums them at the zoo's widths (two-tower's L of 8, 16 and 32), so the
    bags equal the reference's bit for bit (``torch.sum`` takes another
    order): L small adds, not one reduction, on the card."""
    rows = embedding_lookup(table, ids)  # [B, L, D]
    if mask is not None:
        mask = torch.as_tensor(mask, device=table.device)
        rows = rows * mask[..., None].to(rows.dtype)
    out = rows[:, 0]
    for i in range(1, rows.shape[1]):
        out = out + rows[:, i]
    if combiner == "mean":
        if mask is not None:
            denom = torch.sum(mask, dim=1, keepdim=True).to(rows.dtype)
        else:
            denom = torch.full((ids.shape[0], 1), ids.shape[1], dtype=rows.dtype,
                               device=rows.device)
        out = out / torch.clamp(denom, min=1.0)
    return out


_U32 = 0xFFFFFFFF


def hash_bucket(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Deterministic hashing trick for unbounded id spaces: the reference's
    uint32 hash (wrapping products), computed in int64 masked to 32 bits
    (each product stays below 2^59). Returns int32 buckets in [0, vocab)."""
    h = torch.as_tensor(ids).to(torch.int64) & _U32  # int32 -> uint32 wraps negatives
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _U32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _U32
    h = h ^ (h >> 16)
    return (h % vocab).to(torch.int32)


def mlp_params(key: torch.Tensor, dims: Sequence[int], dtype=torch.float32,
               device="cuda") -> nn.ModuleList:
    """Layers ``{"w": N(0, 1) * sqrt(2 / d_in) [d_in, d_out], "b": 0 [d_out]}``,
    layer i drawn from ``split(key, len(dims) - 1)[i]``."""
    device = resolve_device(device)
    layers = nn.ModuleList()
    for k, a, b in zip(prng.split(key, len(dims) - 1), dims[:-1], dims[1:]):
        w = prng.normal(k, (a, b), mul=np.sqrt(np.float32(2.0 / a)), dtype=dtype, device=device)
        layers.append(nn.ParameterDict({
            "w": nn.Parameter(w),
            "b": nn.Parameter(torch.zeros((b,), dtype=dtype, device=device)),
        }))
    return layers


def mlp_tree(key: torch.Tensor, dims: Sequence[int], dtype=torch.float32,
             device="cuda") -> list:
    """``mlp_params`` as a parameter tree: a list of ``{"w", "b"}`` tensors."""
    return [{"w": l["w"].detach(), "b": l["b"].detach()}
            for l in mlp_params(key, dims, dtype, device)]


def mlp_apply(layers, x: torch.Tensor,
              final_act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """``x @ w + b`` per layer, ReLU between layers, ``final_act`` (if any) after the last."""
    full_fp32_matmul()
    for i, layer in enumerate(layers):
        x = torch.matmul(x, layer["w"]) + layer["b"]
        if i + 1 < len(layers):
            x = torch.relu(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` on every leaf of a tree of dictionaries, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """An array as a tensor of its own dtype, a bfloat16 array (the
    reference's ``ml_dtypes`` type, known here by name) bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def tree_from_numpy(tree, dtype=torch.float32, device="cuda"):
    """A tree of arrays (the reference's parameters as numpy) as tensors on
    ``device``, cast to ``dtype``, or each of its own dtype when ``dtype``
    is None (``tensor_from_numpy``: bfloat16 leaves exactly)."""
    device = resolve_device(device)
    if dtype is None:
        return tree_map(lambda a: tensor_from_numpy(a, device), tree)
    return tree_map(lambda a: torch.tensor(np.array(a), dtype=dtype, device=device), tree)


def tree_to_numpy(tree):
    """A tree of tensors as numpy arrays (copies), in the reference's layout."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)
