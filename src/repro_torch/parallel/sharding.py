"""Sharding rules: logical parameter/activation layouts per model family
(ports ``repro/parallel/sharding.py``).

The reference's conventions, as data:

  * mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
    multi-pod; ``pod`` composes with ``data`` for data parallelism.
  * LM params: FSDP over ``data`` x TP over ``model`` (MaxText-style 2D);
    the optimizer state inherits them.
  * MoE experts: EP over ``model`` when the experts divide it, else TP
    inside the experts.
  * recsys embedding tables: row-sharded over (data, model).
  * GNN: edges sharded over the whole mesh, node states over ``model``.
  * activations: batch over dp; Megatron-SP (sequence over ``model``) for
    the residual stream between layers.

A ``Spec`` is a ``PartitionSpec``'s entries as a tuple (``None``, an axis
name, or a tuple of axis names, one entry per leading dim), and a
``Sharding`` is the counterpart of ``NamedSharding``: a spec over a
``launch/mesh.LeafMesh``. One process drives every leaf, so nothing here
runs SPMD: the specs say which piece of a tensor each leaf holds
(``shard_tree``), what that costs a leaf (``Sharding.shard_bytes``), and a
step over sharded state gathers it onto one device, runs there and lays
the result out again (``run_gathered``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.launch.mesh import LeafMesh
from repro_torch.train.checkpoint import flatten_tree, unflatten_tree

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``spec`` over ``mesh``: dim i of a tensor is split over the mesh axes
    of ``spec[i]`` (the first axis major); dims past the spec and ``None``
    entries are whole on every leaf."""

    mesh: LeafMesh
    spec: Spec = ()

    def __post_init__(self):
        # as a NamedSharding holds its spec: a tuple of one axis is that axis,
        # an empty tuple None
        spec = tuple((e[0] if len(e) == 1 else tuple(e) or None)
                     if isinstance(e, (tuple, list)) else e for e in self.spec)
        named = [ax for e in spec if e is not None for ax in ((e,) if isinstance(e, str) else e)]
        for ax in named:
            self.mesh.axis_size(ax)  # raises on an unknown axis
        if len(set(named)) != len(named):
            raise ValueError(f"spec {spec} names a mesh axis twice")
        object.__setattr__(self, "spec", spec)

    def _axes(self, dim: int) -> Tuple[str, ...]:
        e = self.spec[dim] if dim < len(self.spec) else None
        return () if e is None else ((e,) if isinstance(e, str) else tuple(e))

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """A leaf's piece of a tensor of ``shape``. A dim that its mesh axes do
        not divide is rounded up (ceiling division), as GSPMD pads it: every
        piece has this shape, the last ones padded."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {tuple(shape)}")
        return tuple(-(-n // math.prod(self.mesh.axis_size(a) for a in self._axes(i)))
                     for i, n in enumerate(shape))

    def shard_bytes(self, shape, dtype: torch.dtype) -> int:
        """Bytes a leaf holds of a tensor of ``shape`` and ``dtype`` (padding included)."""
        return math.prod(self.shard_shape(shape)) * dtype.itemsize

    def piece_index(self, position: Tuple[int, ...]) -> Tuple[int, ...]:
        """Which piece, dim by dim, the leaf at mesh ``position`` holds."""
        out = []
        for i in range(len(self.spec)):
            idx = 0
            for ax in self._axes(i):
                idx = idx * self.mesh.axis_size(ax) + position[self.mesh.axes.index(ax)]
            out.append(idx)
        return tuple(out)


@dataclasses.dataclass
class ShardedTensor:
    """A tensor of ``shape`` laid out by ``sharding``: ``pieces[i]`` is the
    piece that the leaf at the i-th mesh position (row-major) holds, on
    ``sharding.mesh.devices[i]``; replicated pieces are copies."""

    sharding: Sharding
    shape: Tuple[int, ...]
    pieces: Tuple[torch.Tensor, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def leaf_bytes(self) -> list:
        """Bytes each leaf holds, in mesh order."""
        return [p.numel() * p.element_size() for p in self.pieces]


def _positions(mesh: LeafMesh):
    return itertools.product(*map(range, mesh.shape))


def _region(x: torch.Tensor, idx, piece_shape) -> torch.Tensor:
    """The view of ``x`` that piece ``idx`` covers, clipped at the end (the
    padding past it is not in ``x``)."""
    for d, (i, c) in enumerate(zip(idx, piece_shape)):
        start = min(i * c, x.shape[d])
        x = x.narrow(d, start, min(c, x.shape[d] - start))
    return x


def _shard(x: torch.Tensor, sharding: Sharding) -> ShardedTensor:
    """``x``'s pieces, one for each mesh position, each a copy on its leaf's
    device, zero-padded to ``sharding.shard_shape``."""
    piece_shape = sharding.shard_shape(x.shape)
    pieces = []
    for pos, dev in zip(_positions(sharding.mesh), sharding.mesh.devices):
        part = _region(x, sharding.piece_index(pos), piece_shape)
        piece = torch.zeros(piece_shape, dtype=x.dtype, device=dev)
        piece[tuple(slice(0, n) for n in part.shape)].copy_(part)
        pieces.append(piece)
    return ShardedTensor(sharding, tuple(x.shape), tuple(pieces))


def _unshard(t: ShardedTensor, device) -> torch.Tensor:
    """The whole tensor back on ``device``, the padding dropped."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    for pos, piece in zip(_positions(t.sharding.mesh), t.pieces):
        dst = _region(out, t.sharding.piece_index(pos), piece.shape)
        dst.copy_(piece[tuple(slice(0, n) for n in dst.shape)])
    return out


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` laid out by the ``Sharding`` at the same
    key of ``shardings`` (``checkpoint.flatten_tree``'s keys); a leaf that
    is not a tensor (a host int such as Adam's step) is kept as it is."""
    leaves, specs = flatten_tree(tree), flatten_tree(shardings)
    if list(leaves) != list(specs):
        raise ValueError(f"tree and shardings differ: {sorted(set(leaves) ^ set(specs))}")
    return unflatten_tree(tree, [_shard(v, specs[k]) if isinstance(v, torch.Tensor) else v
                                 for k, v in leaves.items()])


def gather_tree(tree: Any, device) -> Any:
    """``shard_tree``'s inverse: every ``ShardedTensor`` reassembled on ``device``."""
    return unflatten_tree(tree, [_unshard(v, device) if isinstance(v, ShardedTensor) else v
                                 for v in flatten_tree(tree).values()])


def tree_leaf_bytes(tree: Any, shardings: Any) -> int:
    """Bytes one leaf holds of ``tree``'s tensors (meta tensors too) under
    ``shardings``: every leaf's piece is the same size (ceiling division).
    Host numbers hold no device bytes."""
    specs = flatten_tree(shardings)
    return sum(specs[k].shard_bytes(v.shape, v.dtype)
               for k, v in flatten_tree(tree).items() if isinstance(v, torch.Tensor))


def run_gathered(fn, args: Tuple[Any, ...], device, out_shardings: Optional[Tuple[Any, ...]]):
    """``fn`` over sharded arguments: gathered onto ``device``, run there, and
    each output whose entry of ``out_shardings`` is not None laid out again
    (real SPMD over distinct cards is not ported)."""
    out = fn(*(gather_tree(a, device) for a in args))
    if out_shardings is None:
        return out
    return tuple(o if s is None else shard_tree(o, s) for o, s in zip(out, out_shardings))


# ---------------------------------------------------------------------------
# The reference's rules.
# ---------------------------------------------------------------------------


def dp_axes(mesh: LeafMesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axes else ("data",)


def ns(mesh: LeafMesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def lm_param_sharding(mesh: LeafMesh, cfg) -> Dict[str, Any]:
    dp = dp_axes(mesh)
    fsdp = dp  # parameters shard their "reduction" dim over dp (FSDP)
    layer = {
        "attn_norm": ns(mesh, None, None),
        "wq": ns(mesh, None, fsdp, "model"),
        "wk": ns(mesh, None, fsdp, "model"),
        "wv": ns(mesh, None, fsdp, "model"),
        "wo": ns(mesh, None, "model", fsdp),
        "ffn_norm": ns(mesh, None, None),
    }
    if cfg.is_moe:
        if cfg.n_experts % mesh.axis_size("model") == 0:  # expert parallel
            layer.update(
                router=ns(mesh, None, fsdp, None),
                w_gate=ns(mesh, None, "model", fsdp, None),
                w_up=ns(mesh, None, "model", fsdp, None),
                w_down=ns(mesh, None, "model", None, fsdp),
            )
        else:
            layer.update(
                router=ns(mesh, None, fsdp, None),
                w_gate=ns(mesh, None, None, fsdp, "model"),
                w_up=ns(mesh, None, None, fsdp, "model"),
                w_down=ns(mesh, None, None, "model", fsdp),
            )
    else:
        layer.update(
            w_gate=ns(mesh, None, fsdp, "model"),
            w_up=ns(mesh, None, fsdp, "model"),
            w_down=ns(mesh, None, "model", fsdp),
        )
    return {
        "embed": ns(mesh, "model", fsdp),
        "final_norm": ns(mesh, None),
        "layers": layer,
    }


def lm_batch_sharding(mesh: LeafMesh) -> Sharding:
    return ns(mesh, dp_axes(mesh), None)  # tokens [B, S]


def lm_activation_constraint(mesh: LeafMesh, cfg):
    """The constraint on the residual stream between layers (the
    reference's ``with_sharding_constraint``): a DTensor is redistributed
    to the spec (``parallel/spmd.constrain``); on one device it is an
    identity that checks the rank."""
    dp = dp_axes(mesh)
    spec = Sharding(mesh, (dp, "model", None) if cfg.activation_sharding == "seq"
                    else (dp, None, None))

    def constrain(x):
        from repro_torch.parallel import spmd

        return spmd.constrain(x, spec)

    constrain.sharding = spec
    return constrain


def lm_cache_sharding(mesh: LeafMesh, cfg, *, context_parallel: bool):
    """KV cache [L, B, KV, T, hd]."""
    dp = dp_axes(mesh)
    if context_parallel:
        kv = ns(mesh, None, None, None, dp, None)  # shard the time axis
    else:
        kv = ns(mesh, None, dp, None, None, None)  # shard the batch axis
    return {"k": kv, "v": kv, "length": ns(mesh)}


# ---------------------------------------------------------------------------
# RecSys.
# ---------------------------------------------------------------------------


def _map_leaves(fn, tree, names=()):
    """``fn(names, leaf)`` on every leaf; ``names`` are the dictionary keys
    and NamedTuple fields on the way down (None for a sequence index), as
    the reference's rule reads a key path."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, getattr(tree, f), names + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, names + (None,)) for v in tree)
    return fn(names, tree)


def replicate_like(mesh: LeafMesh, tree: Any) -> Any:
    return _map_leaves(lambda _n, _l: ns(mesh), tree)


def recsys_table_sharding(mesh: LeafMesh) -> Sharding:
    return ns(mesh, dp_axes(mesh) + ("model",), None)  # [V, D] row-sharded


def recsys_batch_sharding(mesh: LeafMesh) -> Sharding:
    return ns(mesh, dp_axes(mesh))


def fill_param_sharding(mesh: LeafMesh, params_shape: Any, table_keys: Tuple[str, ...],
                        stacked_table_keys: Tuple[str, ...] = ()) -> Any:
    """A sharding tree for a recsys model: named embedding tables
    row-sharded, everything else replicated."""

    def rule(names, _leaf):
        if any(n in table_keys for n in names):
            return recsys_table_sharding(mesh)
        if any(n in stacked_table_keys for n in names):
            return ns(mesh, None, dp_axes(mesh) + ("model",), None)
        return ns(mesh)

    return _map_leaves(rule, params_shape)


# ---------------------------------------------------------------------------
# GNN.
# ---------------------------------------------------------------------------


def gnn_param_sharding(mesh: LeafMesh, params_shape: Any) -> Any:
    return replicate_like(mesh, params_shape)  # tiny params, replicate


def gnn_edge_sharding(mesh: LeafMesh) -> Sharding:
    # edges shard over the full mesh (they dominate memory at 61M edges)
    return ns(mesh, dp_axes(mesh) + ("model",))


def gnn_edge_feat_sharding(mesh: LeafMesh) -> Sharding:
    return ns(mesh, dp_axes(mesh) + ("model",), None)


def gnn_node_sharding(mesh: LeafMesh) -> Sharding:
    # node states shard over `model` (edges over dp): 2D graph parallelism.
    return ns(mesh, "model", None)
