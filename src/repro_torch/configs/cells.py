"""Cell abstraction: one (architecture x input shape) dry-run unit (ports
``repro/configs/cells.py``).

A ``CellSpec`` carries what ``launch/dryrun.py`` needs to run a production
step on a mesh: the step function, its arguments as meta-device tensors
(the counterpart of ``jax.eval_shape``'s ShapeDtypeStructs: shapes and
dtypes, nothing allocated), their ``parallel/sharding.Sharding`` trees,
and the reference's metadata (parameter counts, tokens or examples per
step).

The arguments are what the port's steps take (``train/steps.py``). Two
leaves differ in kind from the reference's: Adam's ``step`` and the decode
cache's ``length`` are host ints (0) where the reference has int32
scalars, and Adam's moments are ``checkpoint.flatten_tree``-keyed
dictionaries (``steps.init_opt_state``) where the reference nests them
like the parameters; their shardings follow the same layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import prng
from repro_torch.launch.mesh import LeafMesh
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import dien as dien_lib
from repro_torch.models.recsys import dlrm as dlrm_lib
from repro_torch.models.recsys import mind as mind_lib
from repro_torch.models.recsys import two_tower as tt_lib
from repro_torch.models.recsys.embedding import tree_map
from repro_torch.parallel import sharding as shd
from repro_torch.train import optim, steps
from repro_torch.train.checkpoint import flatten_tree

META = torch.device("meta")


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str  # train | prefill | decode | serve | retrieval
    fn: Callable
    abstract_args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    meta: Dict[str, Any]  # params, active_params, tokens/examples, notes


def _spec(shape, dtype) -> torch.Tensor:
    """A meta tensor: the shape and dtype of an argument, no storage."""
    return torch.empty(shape, dtype=dtype, device=META)


def _ns(mesh, *spec):
    return shd.Sharding(mesh, tuple(spec))


ADAM = optim.AdamConfig(lr=3e-4, clip_norm=1.0)


def _opt_for(mesh, params_s, param_sh):
    """Adam's state over meta tensors and its shardings (the parameters')."""
    flat_sh = flatten_tree(param_sh)
    return (steps.init_opt_state(params_s),
            optim.AdamState(step=_ns(mesh), mu=dict(flat_sh), nu=dict(flat_sh)))


# ---------------------------------------------------------------------------
# LM family.
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, context_parallel=True),
}


def lm_cell(cfg: tf.TransformerConfig, shape_id: str, mesh: LeafMesh) -> CellSpec:
    info = LM_SHAPES[shape_id]
    dp = shd.dp_axes(mesh)
    params_s = tf.init_params(cfg, device=META)
    param_sh = shd.lm_param_sharding(mesh, cfg)
    meta = {
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "family": "lm",
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "seq": info["seq"],
        "batch": info["batch"],
    }
    B, S = info["batch"], info["seq"]

    if info["kind"] == "train":
        opt_s, opt_sh = _opt_for(mesh, params_s, param_sh)
        batch_s = {"tokens": _spec((B, S), torch.int32), "labels": _spec((B, S), torch.int32)}
        batch_sh = {"tokens": shd.lm_batch_sharding(mesh),
                    "labels": shd.lm_batch_sharding(mesh)}
        constrain = shd.lm_activation_constraint(mesh, cfg)
        fn = steps.lm_train_step(cfg, ADAM, constrain=constrain)
        meta["tokens_per_step"] = B * S
        return CellSpec(cfg.name, shape_id, "train", fn, (params_s, opt_s, batch_s),
                        (param_sh, opt_sh, batch_sh), meta)

    if info["kind"] == "prefill":
        batch_s = {"tokens": _spec((B, S), torch.int32)}
        batch_sh = {"tokens": shd.lm_batch_sharding(mesh)}
        fn = steps.lm_prefill_step(cfg)
        meta["tokens_per_step"] = B * S
        return CellSpec(cfg.name, shape_id, "prefill", fn, (params_s, batch_s),
                        (param_sh, batch_sh), meta)

    # decode
    cp = info.get("context_parallel", False)
    cache_s = tf.init_kv_cache(cfg, B, S, device=META)
    if cp:
        kv_spec = _ns(mesh, None, None, None, dp, None)
    else:
        kv_spec = _ns(mesh, None, dp, None, "model", None)
    cache_sh = {k: kv_spec for k in cache_s if k != "length"}
    cache_sh["length"] = _ns(mesh)
    batch_s = {"token": _spec((B,), torch.int32)}
    batch_sh = {"token": _ns(mesh, dp) if B > 1 else _ns(mesh, None)}
    fn = steps.lm_decode_step(cfg)
    meta["tokens_per_step"] = B
    meta["cache_len"] = S
    meta["context_parallel"] = cp
    return CellSpec(cfg.name, shape_id, "decode", fn, (params_s, batch_s, cache_s),
                    (param_sh, batch_sh, cache_sh), meta)


# ---------------------------------------------------------------------------
# GNN family (meshgraphnet).
# ---------------------------------------------------------------------------

GNN_SHAPES = {
    "full_graph_sm": dict(nodes=2708, edges=10556, d_feat=1433),
    "minibatch_lg": dict(nodes=169_984, edges=168_960, d_feat=100, sampled=True),
    "ogb_products": dict(nodes=2_449_029, edges=61_859_140, d_feat=100),
    "molecule": dict(nodes=3840, edges=8192, d_feat=16, batched=128),
}


def gnn_cell(base_cfg: gnn_lib.GNNConfig, shape_id: str, mesh: LeafMesh) -> CellSpec:
    info = GNN_SHAPES[shape_id]
    cfg = dataclasses.replace(base_cfg, d_node_in=info["d_feat"], d_edge_in=8)
    params_s = gnn_lib.init_params(cfg, prng.key(0, META), device=META)
    param_sh = shd.replicate_like(mesh, params_s)
    N, E = info["nodes"], info["edges"]
    # pad N/E so nodes shard over `model` and edges over dp (any mesh)
    pad_to = mesh.n_leaves
    N = N + (-N) % pad_to
    E = E + (-E) % pad_to
    batch_s = {
        "node_feat": _spec((N, info["d_feat"]), torch.float32),
        "edge_feat": _spec((E, 8), torch.float32),
        "senders": _spec((E,), torch.int32),
        "receivers": _spec((E,), torch.int32),
        "edge_mask": _spec((E,), torch.bool),
        "targets": _spec((N, cfg.d_out), torch.float32),
    }
    batch_sh = {
        "node_feat": shd.gnn_node_sharding(mesh),
        "edge_feat": shd.gnn_edge_feat_sharding(mesh),
        "senders": shd.gnn_edge_sharding(mesh),
        "receivers": shd.gnn_edge_sharding(mesh),
        "edge_mask": shd.gnn_edge_sharding(mesh),
        "targets": shd.gnn_node_sharding(mesh),
    }
    opt_s, opt_sh = _opt_for(mesh, params_s, param_sh)
    fn = steps.gnn_train_step(cfg, ADAM)
    meta = {
        "params": cfg.param_count(), "active_params": cfg.param_count(),
        "family": "gnn", "nodes": N, "edges": E, "d_hidden": cfg.d_hidden,
        "n_layers": cfg.n_layers,
    }
    return CellSpec(base_cfg.name, shape_id, "train", fn, (params_s, opt_s, batch_s),
                    (param_sh, opt_sh, batch_sh), meta)


# ---------------------------------------------------------------------------
# RecSys family.
# ---------------------------------------------------------------------------

RS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, candidates=1_000_000),
}


def _by_rank(mesh, dp, batch_s):
    """Rows over dp: ``(dp, None)`` for a 2-D leaf, ``(dp,)`` for a 1-D one."""
    return {k: _ns(mesh, dp, None) if v.dim() == 2 else _ns(mesh, dp)
            for k, v in batch_s.items()}


def dlrm_cell(cfg: dlrm_lib.DLRMConfig, shape_id: str, mesh: LeafMesh) -> CellSpec:
    info = RS_SHAPES[shape_id]
    dp = shd.dp_axes(mesh)
    params_s = tree_map(torch.Tensor.detach,
                        dlrm_lib.init_dlrm(cfg, prng.key(0, META), device=META).tree())
    param_sh = shd.fill_param_sharding(mesh, params_s, (), stacked_table_keys=("tables",))
    meta = {"params": cfg.param_count(), "active_params": cfg.param_count(),
            "family": "recsys", "model": "dlrm", "batch": info["batch"],
            "embed_dim": cfg.embed_dim, "n_sparse": cfg.n_sparse}

    B = info["batch"] if info["kind"] != "retrieval" else info["candidates"]
    batch_s = {
        "dense": _spec((B, cfg.n_dense), torch.float32),
        "sparse_ids": _spec((B, cfg.n_sparse), torch.int32),
    }
    # candidate rows shard over dp (1e6 divides dp extents, not dp*model)
    batch_sh = {"dense": _ns(mesh, dp, None), "sparse_ids": _ns(mesh, dp, None)}
    meta["examples_per_step"] = B

    if info["kind"] == "train":
        batch_s["labels"] = _spec((B,), torch.float32)
        batch_sh["labels"] = _ns(mesh, dp)
        opt_s, opt_sh = _opt_for(mesh, params_s, param_sh)
        fn = steps.dlrm_train_step(cfg, ADAM)
        return CellSpec(cfg.name, shape_id, "train", fn, (params_s, opt_s, batch_s),
                        (param_sh, opt_sh, batch_sh), meta)
    fn = steps.dlrm_serve_step(cfg)
    return CellSpec(cfg.name, shape_id, info["kind"], fn, (params_s, batch_s),
                    (param_sh, batch_sh), meta)


def tt_cell(cfg: tt_lib.TwoTowerConfig, shape_id: str, mesh: LeafMesh) -> CellSpec:
    info = RS_SHAPES[shape_id]
    dp = shd.dp_axes(mesh)
    params_s = tt_lib.init_params(cfg, prng.key(0, META), device=META)
    param_sh = shd.fill_param_sharding(mesh, params_s, table_keys=("user_table", "item_table"))
    meta = {"params": cfg.param_count(), "active_params": cfg.param_count(),
            "family": "recsys", "model": "two_tower", "batch": info["batch"],
            "embed_dim": cfg.embed_dim}
    L = cfg.hist_len

    if info["kind"] == "train":
        B = info["batch"]
        batch_s = {
            "hist_ids": _spec((B, L), torch.int32),
            "hist_mask": _spec((B, L), torch.float32),
            "pos_items": _spec((B,), torch.int32),
            "item_logq": _spec((B,), torch.float32),
        }
        batch_sh = _by_rank(mesh, dp, batch_s)
        opt_s, opt_sh = _opt_for(mesh, params_s, param_sh)
        fn = steps.tt_train_step(cfg, ADAM)
        meta["examples_per_step"] = B
        return CellSpec(cfg.name, shape_id, "train", fn, (params_s, opt_s, batch_s),
                        (param_sh, opt_sh, batch_sh), meta)

    if info["kind"] == "retrieval":
        Bq, Nc = info["batch"], info["candidates"]
        batch_s = {
            "hist_ids": _spec((Bq, L), torch.int32),
            "hist_mask": _spec((Bq, L), torch.float32),
            "cand_ids": _spec((Nc,), torch.int32),
        }
        batch_sh = {"hist_ids": _ns(mesh, None, None), "hist_mask": _ns(mesh, None, None),
                    "cand_ids": _ns(mesh, dp)}
        fn = steps.tt_retrieval_step(cfg, k=100)
        meta["examples_per_step"] = Nc
        meta["candidates"] = Nc
        return CellSpec(cfg.name, shape_id, "retrieval", fn, (params_s, batch_s),
                        (param_sh, batch_sh), meta)

    B = info["batch"]
    batch_s = {
        "hist_ids": _spec((B, L), torch.int32),
        "hist_mask": _spec((B, L), torch.float32),
        "cand_ids": _spec((256,), torch.int32),
    }
    batch_sh = {"hist_ids": _ns(mesh, dp, None), "hist_mask": _ns(mesh, dp, None),
                "cand_ids": _ns(mesh, None)}
    fn = steps.tt_serve_step(cfg)
    meta["examples_per_step"] = B
    return CellSpec(cfg.name, shape_id, "serve", fn, (params_s, batch_s),
                    (param_sh, batch_sh), meta)


def mind_cell(cfg: mind_lib.MINDConfig, shape_id: str, mesh: LeafMesh) -> CellSpec:
    info = RS_SHAPES[shape_id]
    dp = shd.dp_axes(mesh)
    params_s = mind_lib.init_params(cfg, prng.key(0, META), device=META)
    param_sh = shd.fill_param_sharding(mesh, params_s, table_keys=("item_table",))
    meta = {"params": cfg.param_count(), "active_params": cfg.param_count(),
            "family": "recsys", "model": "mind", "batch": info["batch"],
            "embed_dim": cfg.embed_dim}
    L = cfg.hist_len

    if info["kind"] == "train":
        B = info["batch"]
        batch_s = {
            "hist_ids": _spec((B, L), torch.int32),
            "hist_mask": _spec((B, L), torch.float32),
            "pos_items": _spec((B,), torch.int32),
            "neg_items": _spec((B, 8), torch.int32),
        }
        batch_sh = _by_rank(mesh, dp, batch_s)
        opt_s, opt_sh = _opt_for(mesh, params_s, param_sh)
        fn = steps.mind_train_step(cfg, ADAM)
        meta["examples_per_step"] = B
        return CellSpec(cfg.name, shape_id, "train", fn, (params_s, opt_s, batch_s),
                        (param_sh, opt_sh, batch_sh), meta)

    if info["kind"] == "retrieval":
        Bq, Nc = info["batch"], info["candidates"]
        batch_s = {
            "hist_ids": _spec((Bq, L), torch.int32),
            "hist_mask": _spec((Bq, L), torch.float32),
            "cand_ids": _spec((Nc,), torch.int32),
        }
        batch_sh = {"hist_ids": _ns(mesh, None, None), "hist_mask": _ns(mesh, None, None),
                    "cand_ids": _ns(mesh, dp)}
        fn = steps.mind_retrieval_step(cfg, k=100)
        meta["examples_per_step"] = Nc
        return CellSpec(cfg.name, shape_id, "retrieval", fn, (params_s, batch_s),
                        (param_sh, batch_sh), meta)

    B = info["batch"]
    batch_s = {
        "hist_ids": _spec((B, L), torch.int32),
        "hist_mask": _spec((B, L), torch.float32),
    }
    batch_sh = {k: _ns(mesh, dp, None) for k in batch_s}
    fn = steps.mind_serve_step(cfg)
    meta["examples_per_step"] = B
    return CellSpec(cfg.name, shape_id, "serve", fn, (params_s, batch_s),
                    (param_sh, batch_sh), meta)


def dien_cell(cfg: dien_lib.DIENConfig, shape_id: str, mesh: LeafMesh) -> CellSpec:
    info = RS_SHAPES[shape_id]
    dp = shd.dp_axes(mesh)
    params_s = dien_lib.init_params(cfg, prng.key(0, META), device=META)
    param_sh = shd.fill_param_sharding(mesh, params_s, table_keys=("item_table", "cate_table"))
    meta = {"params": cfg.param_count(), "active_params": cfg.param_count(),
            "family": "recsys", "model": "dien", "batch": info["batch"],
            "embed_dim": cfg.embed_dim, "seq": cfg.seq_len}
    L = cfg.seq_len
    B = info["batch"] if info["kind"] != "retrieval" else info["candidates"]

    batch_s = {
        "hist_items": _spec((B, L), torch.int32),
        "hist_cates": _spec((B, L), torch.int32),
        "hist_mask": _spec((B, L), torch.float32),
        "target_item": _spec((B,), torch.int32),
        "target_cate": _spec((B,), torch.int32),
    }
    batch_sh = _by_rank(mesh, dp, batch_s)
    meta["examples_per_step"] = B

    if info["kind"] == "train":
        batch_s["labels"] = _spec((B,), torch.float32)
        batch_sh["labels"] = _ns(mesh, dp)
        opt_s, opt_sh = _opt_for(mesh, params_s, param_sh)
        fn = steps.dien_train_step(cfg, ADAM)
        return CellSpec(cfg.name, shape_id, "train", fn, (params_s, opt_s, batch_s),
                        (param_sh, opt_sh, batch_sh), meta)
    fn = steps.dien_serve_step(cfg)
    return CellSpec(cfg.name, shape_id, info["kind"], fn, (params_s, batch_s),
                    (param_sh, batch_sh), meta)
