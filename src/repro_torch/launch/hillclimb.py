"""Perf hillclimbing driver (ports ``repro/launch/hillclimb.py``): run named
variants of the three target cells sharded over the production mesh,
price their roofline terms against the baseline, log each to
perf_torch_results.json.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell tt_retrieval \\
        --variant bebr_sdc [--multi-pod] [--out perf_torch_results.json]

Cells and variants are defined in ``VARIANTS`` under the reference's
names; the baselines are the cells ``launch/dryrun.py`` runs, so the deltas
are like for like. The reference lowers and compiles each variant with
GSPMD for 256 or 512 fake host devices and walks the HLO. The port runs
the step once on DTensors over a fake process group of as many ranks
(``parallel/spmd.fake_mesh``), on meta tensors, and counts what rank 0
runs (``hlo_cost.sharded_step_costs``): the meta device and the fake
group are the cost model's by design, as the reference's host devices
are its; nothing falls back to the CPU, and nothing touches a card.

A record keeps the reference's keys (``flops``, ``bytes``, ``wire_bytes``,
``collectives``, ``compute_ms``, ``memory_ms``, ``collective_ms``,
``peak_gib``), all per device, priced with the H100 roofline constants of
``kernels/sdc/defaults.py``; ``run_s`` takes the place of ``compile_s``.
It adds ``counts`` (collectives by kind), ``replicated`` (operators
whose sharding DTensor could not propagate, run on replicated operands),
``replicated_at`` (where each was called, and its operands' layouts) and
``strided`` (redistributions of DTensor's strided layout, by the line
that asked for each).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import prng
from repro_torch.configs import cells as cells_mod
from repro_torch.configs.archs import grok_1_314b, llama3_405b
from repro_torch.configs.registry import build_cell, get_arch
from repro_torch.kernels.sdc.defaults import HBM_BW, LINK_BW, N_LINKS, PEAK_FLOPS
from repro_torch.kernels.sdc.sdc import select_topk
from repro_torch.launch.hlo_cost import sharded_step_costs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import gnn as gnn_lib
from repro_torch.models.recsys import two_tower as tt
from repro_torch.models.recsys.embedding import mlp_apply
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd
from repro_torch.train import optim, steps
from repro_torch.train.checkpoint import flatten_tree, unflatten_tree

_spec, META = cells_mod._spec, cells_mod.META


def _measure(fn, shardings, args, mesh) -> dict:
    t0 = time.perf_counter()
    costs = sharded_step_costs(fn, args, shardings, mesh)
    dt = time.perf_counter() - t0
    wire = sum(costs["collectives"].values())
    return {
        "ok": True,
        "run_s": round(dt, 1),
        "flops": costs["flops"],
        "bytes": costs["bytes"],
        "wire_bytes": wire,
        "collectives": costs["collectives"],
        "counts": costs["counts"],
        "compute_ms": 1e3 * costs["flops"] / PEAK_FLOPS,
        "memory_ms": 1e3 * costs["bytes"] / HBM_BW,
        "collective_ms": 1e3 * wire / (N_LINKS * LINK_BW),
        "peak_gib": costs["peak_bytes"] / 2**30,
        "replicated": costs["replicated"],
        "replicated_at": costs["replicated_at"],
        "strided": costs["strided"],
    }


def _replicated_state(mesh, params_s):
    """Adam's state over ``params_s`` and replicated shardings for both."""
    rep = shd.replicate_like(mesh, params_s)
    opt_s, opt_sh = cells_mod._opt_for(mesh, params_s, rep)
    return rep, opt_s, opt_sh


# ---------------------------------------------------------------------------
# Cell: two-tower retrieval_cand (paper-representative).
# ---------------------------------------------------------------------------


def tt_retrieval_baseline(mesh):
    cell = build_cell("two-tower-retrieval", "retrieval_cand", mesh)
    return cell.fn, cell.in_shardings, cell.abstract_args


def _tt_params(cfg, mesh, binarizer=None):
    params_s = tt.init_params(cfg, prng.key(0, META), device=META)
    if binarizer is not None:
        params_s["binarizer"] = binarizer
    return params_s, shd.fill_param_sharding(mesh, params_s, ("user_table", "item_table"))


def tt_retrieval_float_index(mesh):
    """Production float baseline: candidates as a precomputed f32 embedding
    index (no per-query tower recompute), the paper's 'float flat' row."""
    cfg = get_arch("two-tower-retrieval").config
    dp = shd.dp_axes(mesh)
    params_s, param_sh = _tt_params(cfg, mesh)
    Nc, D = 1_000_000, cfg.tower_mlp[-1]
    batch_s = {
        "hist_ids": _spec((1, cfg.hist_len), torch.int32),
        "hist_mask": _spec((1, cfg.hist_len), torch.float32),
        "cand_emb": _spec((Nc, D), torch.float32),
    }
    batch_sh = {"hist_ids": shd.ns(mesh, None, None), "hist_mask": shd.ns(mesh, None, None),
                "cand_emb": shd.ns(mesh, dp, None)}

    def step(params, batch):
        with torch.no_grad():
            q = tt.query_embed(params, batch["hist_ids"], batch["hist_mask"], cfg)
            scores = (batch["cand_emb"] @ q[0])[None, :]
            return select_topk(scores, 100)

    return step, (param_sh, batch_sh), (params_s, batch_s)


def _binarizer(emb_out, code_dim, n_levels):
    return {"W": [_spec((emb_out, code_dim), torch.float32) for _ in range(n_levels)],
            "R": [_spec((code_dim, emb_out), torch.float32) for _ in range(n_levels - 1)]}


def tt_retrieval_bebr(mesh, code_dim=64, n_levels=4, n_cand=1_000_000):
    """The paper's technique as the optimisation: int8 SDC index scan."""
    cfg = get_arch("two-tower-retrieval").config
    dp = shd.dp_axes(mesh)
    params_s, param_sh = _tt_params(cfg, mesh,
                                    _binarizer(cfg.tower_mlp[-1], code_dim, n_levels))
    batch_s = {
        "hist_ids": _spec((1, cfg.hist_len), torch.int32),
        "hist_mask": _spec((1, cfg.hist_len), torch.float32),
        "cand_codes": _spec((n_cand, code_dim), torch.int8),
        "cand_inv": _spec((n_cand,), torch.float32),
    }
    batch_sh = {"hist_ids": shd.ns(mesh, None, None), "hist_mask": shd.ns(mesh, None, None),
                "cand_codes": shd.ns(mesh, dp, None), "cand_inv": shd.ns(mesh, dp)}
    fn = steps.tt_retrieval_bebr_step(cfg, k=100, code_dim=code_dim, n_levels=n_levels)
    return fn, (param_sh, batch_sh), (params_s, batch_s)


def tt_retrieval_bebr_full(mesh, n_cand=1_000_000):
    """BEBR + candidates sharded over the full mesh (dp x model)."""
    fn, (param_sh, batch_sh), (params_s, batch_s) = tt_retrieval_bebr(mesh, n_cand=n_cand)
    dp = shd.dp_axes(mesh)
    # 1e6 doesn't divide dp*model; pad to the next multiple
    Nc = n_cand + (-n_cand) % mesh.n_leaves
    batch_s = dict(batch_s, cand_codes=_spec((Nc, 64), torch.int8),
                   cand_inv=_spec((Nc,), torch.float32))
    batch_sh = dict(batch_sh, cand_codes=shd.ns(mesh, dp + ("model",), None),
                    cand_inv=shd.ns(mesh, dp + ("model",)))
    return fn, (param_sh, batch_sh), (params_s, batch_s)


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """``jax.lax.top_k`` of gathered candidates ``vals`` [1, n] with their
    ``ids`` [1, n]: descending in IEEE total order, ties to the earlier
    position (the lower leaf, then its own order)."""
    pos = torch.sort(steps._total_order(vals), dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(vals, 1, pos), torch.gather(ids, 1, pos)


def tt_retrieval_bebr_merge(mesh, code_dim=64, n_levels=4, n_cand=1_000_000):
    """BEBR + the paper's selection merge: per-leaf top-k under shard_map,
    all-gather only the k results (wire: the scores array -> k entries a leaf).

    A leaf's top k is ``steps.sdc_topk_every_row`` over its rows (the
    ``sdc_topk`` kernel on the card, every row competing as in the
    reference); ids are offset by the leaf's rank over the data axes."""
    cfg = get_arch("two-tower-retrieval").config
    _, shardings, abstract = tt_retrieval_bebr(mesh, code_dim, n_levels, n_cand)
    dp = shd.dp_axes(mesh)
    k = 100

    def leaf(q_code8, cand_codes, cand_inv):
        vals, idx = steps.sdc_topk_every_row(q_code8, cand_codes, cand_inv,
                                             n_levels=n_levels, k=k)
        gidx = idx + spmd.axis_index(mesh, dp) * cand_codes.shape[0]
        av = spmd.all_gather(vals, mesh, dp, axis=1, tiled=True)
        ai = spmd.all_gather(gidx, mesh, dp, axis=1, tiled=True)
        return merge_topk(av, ai, k)

    leaf_sharded = spmd.shard_map(leaf, mesh, in_specs=((None, None), (dp, None), (dp,)),
                                  out_specs=((), ()))

    def step(params, batch):
        with torch.no_grad():
            q = tt.query_embed(params, batch["hist_ids"], batch["hist_mask"], cfg)
            code = steps.binarize_linear(params["binarizer"], q, n_levels)
            return leaf_sharded(code.to(torch.int8), batch["cand_codes"], batch["cand_inv"])

    return step, shardings, abstract


# ---------------------------------------------------------------------------
# Cell: meshgraphnet ogb_products (most collective-bound).
# ---------------------------------------------------------------------------


def _gnn_cfg(**overrides):
    return dataclasses.replace(get_arch("meshgraphnet").config,
                               d_node_in=cells_mod.GNN_SHAPES["ogb_products"]["d_feat"],
                               d_edge_in=8, **overrides)


def gnn_ogb_baseline(mesh):
    cell = build_cell("meshgraphnet", "ogb_products", mesh)
    return cell.fn, cell.in_shardings, cell.abstract_args


def _node_constrain(mesh):
    sharding = shd.ns(mesh, "model", None)
    return lambda x: spmd.constrain(x, sharding)


def gnn_ogb_node_constrained(mesh):
    """Constrain aggregates/states to the node partition: all-reduce ->
    reduce-scatter + all-gather, node MLP runs sharded."""
    cell = cells_mod.gnn_cell(get_arch("meshgraphnet").config, "ogb_products", mesh)
    fn = steps.gnn_train_step(_gnn_cfg(), cells_mod.ADAM, node_constrain=_node_constrain(mesh))
    return fn, cell.in_shardings, cell.abstract_args


def gnn_ogb_bf16_edges(mesh):
    """node constraint + bf16 message/aggregate arithmetic (halves both the
    HBM and wire bytes of the edge pipeline)."""
    cell = cells_mod.gnn_cell(get_arch("meshgraphnet").config, "ogb_products", mesh)
    cfg = _gnn_cfg(dtype=torch.bfloat16)
    fn = steps.gnn_train_step(cfg, cells_mod.ADAM, node_constrain=_node_constrain(mesh))
    params_s = gnn_lib.init_params(cfg, prng.key(0, META), device=META)
    rep, opt_s, opt_sh = _replicated_state(mesh, params_s)
    return fn, (rep, opt_sh, cell.in_shardings[2]), (params_s, opt_s, cell.abstract_args[2])


def _partitioned_setup(mesh, extra=()):
    """Config, padded sizes, mesh axes, replicated parameters and Adam state
    (and their shardings), and the batch sharded over the whole mesh
    (``extra``: more [E] keys) of the shard_map variants."""
    info = cells_mod.GNN_SHAPES["ogb_products"]
    cfg = _gnn_cfg()
    n_all = mesh.n_leaves
    N = info["nodes"] + (-info["nodes"]) % n_all
    E = info["edges"] + (-info["edges"]) % n_all
    axes = tuple(mesh.axes)  # shard over the whole mesh
    params_s = gnn_lib.init_params(cfg, prng.key(0, META), device=META)
    rep, opt_s, opt_sh = _replicated_state(mesh, params_s)
    state = (params_s, rep, opt_s, opt_sh)
    batch_s = {
        "node_feat": _spec((N, info["d_feat"]), torch.float32),
        "edge_feat": _spec((E, 8), torch.float32),
        "senders": _spec((E,), torch.int32),
        "receivers": _spec((E,), torch.int32),
        "edge_mask": _spec((E,), torch.bool),
        "targets": _spec((N, cfg.d_out), torch.float32),
    }
    for key, dtype in extra:
        batch_s[key] = _spec((E,), dtype)
    batch_sh = {k: shd.ns(mesh, axes, None) if v.dim() == 2 else shd.ns(mesh, axes)
                for k, v in batch_s.items()}
    return cfg, N, E, axes, state, batch_s, batch_sh


def _sharded_train_step(mesh, axes, local_loss, in_specs, batch_keys):
    """``step(params, opt_state, batch)``: ``local_loss``'s value and
    gradients on each rank's pieces under ``shard_map`` (the loss summed
    over the ranks, the gradients averaged), then Adam on the replicated
    parameters, as the reference's shard_map variants do."""
    def sharded_grads(params, *batch):
        flat = flatten_tree(params)
        leaves = [t.detach().requires_grad_(True) for t in flat.values()]
        sq, scale = local_loss(unflatten_tree(params, leaves), *batch)
        grads = torch.autograd.grad(sq * scale, leaves, allow_unused=True)
        grads = {k: spmd.pmean(torch.zeros_like(p) if g is None else g, mesh, axes)
                 for (k, p), g in zip(flat.items(), grads)}
        return spmd.psum(sq.detach(), mesh, axes) * scale, grads

    gfn = spmd.shard_map(sharded_grads, mesh, in_specs=((),) + tuple(in_specs),
                         out_specs=((), ()))

    def step(params, opt_state, batch):
        loss, grads = gfn(params, *(batch[k] for k in batch_keys))
        # each rank's gradient is of its own share of the loss, so the
        # average over the ranks times their number is the whole one
        n = spmd.group_size(mesh, axes)
        grads = {k: g * n for k, g in grads.items()}
        norm = optim.global_norm(grads)
        opt_state = optim.adam_update_(grads, opt_state, flatten_tree(params), cells_mod.ADAM, norm=norm)
        return params, opt_state, {"loss": loss}

    return step


def gnn_ogb_partitioned(mesh, gather_dtype=None):
    """Receiver-partitioned message passing (shard_map).

    Data contract: the host pipeline sorts edges so edge e lives on the
    device owning receiver[e] (standard partition-aware graph loading).
    Then: one all-gather of node states per layer (senders may be remote),
    the segment sum is fully local (no all-reduce), the node MLP runs on the
    local node shard; the all-gather's reduce-scatter in the backward.

    Each layer is checkpointed keeping its all-gather and its products
    (``spmd.checkpoint(save_products=True)``): the reference's compiled
    record of this variant runs no recompute of them (its FLOPs a device
    within 1% of the step without a checkpoint)."""
    cfg, N, E, axes, (params_s, rep, opt_s, opt_sh), batch_s, batch_sh = _partitioned_setup(mesh)
    n_loc = N // mesh.n_leaves
    keys = ("node_feat", "edge_feat", "senders", "receivers", "edge_mask", "targets")

    def layer_fn(lp, v, e, snd, rcv, msk, base):
        vg = v.to(gather_dtype) if gather_dtype is not None else v
        v_full = spmd.all_gather(vg, mesh, axes, axis=0, tiled=True)  # [N, h]
        vs = v_full[snd].to(v.dtype)
        vr = v_full[rcv].to(v.dtype)
        e_new = mlp_apply(lp["edge_mlp"], torch.cat([e, vs, vr], -1))
        e = e + e_new * msk[:, None]
        # receivers are local by the partitioning contract
        agg = gnn_lib.segment_sum(e, rcv - base, n_loc)
        v = v + mlp_apply(lp["node_mlp"], torch.cat([v, agg], -1))
        return v, e

    def local_loss(params, nf, ef, snd, rcv, msk, tgt):
        base = spmd.axis_index(mesh, axes) * n_loc
        snd, rcv = snd.long(), rcv.long()
        msk = msk.to(torch.float32)
        v = mlp_apply(params["node_enc"], nf)  # [n_loc, h]
        e = mlp_apply(params["edge_enc"], ef) * msk[:, None]
        for lp in params["layers"]:
            v, e = spmd.checkpoint(layer_fn, lp, v, e, snd, rcv, msk, base,
                                   save_products=True)
        out = mlp_apply(params["decoder"], v)
        return torch.sum(torch.square(out - tgt)), 1.0 / (N * cfg.d_out)

    in_specs = [(axes, None), (axes, None), (axes,), (axes,), (axes,), (axes, None)]
    step = _sharded_train_step(mesh, axes, local_loss, in_specs, keys)
    return step, (rep, opt_sh, batch_sh), (params_s, opt_s, batch_s)


def _halo_fetch(mesh, axes, req_recv, n_all, bucket):
    """The halo response: the rows of ``v`` each peer asked for
    (``req_recv`` [peer, slot] local node ids, -1 padding) sent back by an
    all-to-all, row for request (owner o, slot s) at o * bucket + s."""
    def fetch(v):
        rows = v[req_recv.clamp(min=0).reshape(-1)]
        rows = rows * (req_recv >= 0).reshape(-1, 1).to(rows.dtype)
        rows = rows.reshape(n_all, 1, bucket, rows.shape[-1])
        resp = spmd.all_to_all(rows, mesh, axes, split_axis=0, concat_axis=1)
        return resp.reshape(n_all * bucket, rows.shape[-1])

    return fetch


def gnn_ogb_halo(mesh, slack: float = 2.0):
    """Halo exchange: instead of all-gathering the full node array, each
    device requests exactly the sender rows its local edges touch via a
    request/response all-to-all pair. Wire per layer ~ 2 * E_loc * h * 4B vs
    the all-gather of the node array, and it improves with partition
    quality, unlike the all-gather.

    Static shapes: per-destination request buckets are padded to slack *
    E_loc / n_shards (uniform senders: Poisson tails; slack=2 bounds the
    overflow far beyond 6 sigma at these sizes)."""
    cfg, N, E, axes, (params_s, rep, opt_s, opt_sh), batch_s, batch_sh = _partitioned_setup(mesh)
    n_all = mesh.n_leaves
    n_loc, e_loc = N // n_all, E // n_all
    bucket = int(slack * e_loc / n_all) + 1  # per-peer request capacity
    keys = ("node_feat", "edge_feat", "senders", "receivers", "edge_mask", "targets")

    def local_loss(params, nf, ef, snd, rcv, msk, tgt):
        base = spmd.axis_index(mesh, axes) * n_loc
        snd, rcv = snd.long(), rcv.long()
        msk = msk.to(torch.float32)
        v = mlp_apply(params["node_enc"], nf)
        e = mlp_apply(params["edge_enc"], ef) * msk[:, None]
        # static routing plan (independent of the layer, computed once)
        owner = torch.div(snd, n_loc, rounding_mode="floor")  # [e_loc]
        order = torch.sort(owner, stable=True).indices  # edges grouped by owner
        snd_sorted, own_sorted = snd[order], owner[order]
        group_start = torch.searchsorted(own_sorted, torch.arange(n_all, device=snd.device),
                                         side="left")
        pos_in_bucket = torch.arange(e_loc, device=snd.device) - group_start[own_sorted]
        keep = pos_in_bucket < bucket
        slot = pos_in_bucket.clamp(0, bucket - 1)
        # int32 requests, as the reference sends them
        req = torch.full((n_all, bucket), -1, dtype=torch.int32, device=snd.device)
        req = req.index_put((own_sorted, slot), torch.where(
            keep, torch.remainder(snd_sorted, n_loc), -1).to(torch.int32))
        req_recv = spmd.all_to_all(req.reshape(n_all, 1, bucket), mesh, axes, split_axis=0,
                                   concat_axis=1).reshape(n_all, bucket).long()
        fetch = _halo_fetch(mesh, axes, req_recv, n_all, bucket)
        flat_idx = own_sorted * bucket + slot

        def layer_fn(lp, v, e):
            resp = fetch(v)
            vs_sorted = resp[flat_idx] * keep[:, None].to(v.dtype)
            vs = torch.zeros_like(vs_sorted).index_put((order,), vs_sorted)
            vr = v[rcv - base]  # receivers are local
            e_new = mlp_apply(lp["edge_mlp"], torch.cat([e, vs, vr], -1))
            e = e + e_new * msk[:, None]
            agg = gnn_lib.segment_sum(e, rcv - base, n_loc)
            v = v + mlp_apply(lp["node_mlp"], torch.cat([v, agg], -1))
            return v, e

        for lp in params["layers"]:
            v, e = spmd.checkpoint(layer_fn, lp, v, e)
        out = mlp_apply(params["decoder"], v)
        return torch.sum(torch.square(out - tgt)), 1.0 / (N * cfg.d_out)

    in_specs = [(axes, None), (axes, None), (axes,), (axes,), (axes,), (axes, None)]
    step = _sharded_train_step(mesh, axes, local_loss, in_specs, keys)
    return step, (rep, opt_sh, batch_sh), (params_s, opt_s, batch_s)


def gnn_ogb_halo_hostplan(mesh, slack: float = 2.0):
    """Halo exchange with the routing plan precomputed by the data pipeline
    (static per graph, like the receiver partitioning): the step receives
    request tables and unsort indices as inputs, so its own work is the two
    all-to-alls and gathers, no sort or scatter on the device."""
    cfg, N, E, axes, (params_s, rep, opt_s, opt_sh), batch_s, batch_sh = _partitioned_setup(
        mesh, extra=(("fetch_idx", torch.int32), ("fetch_valid", torch.bool)))
    n_all = mesh.n_leaves
    n_loc, e_loc = N // n_all, E // n_all
    bucket = int(slack * e_loc / n_all) + 1
    del batch_s["senders"], batch_sh["senders"]
    # req is per-device data: a leading device axis, sharded over the mesh
    batch_s["req"] = _spec((n_all, n_all * bucket), torch.int32)
    batch_sh["req"] = shd.ns(mesh, axes, None)
    keys = ("node_feat", "edge_feat", "receivers", "edge_mask", "targets", "req",
            "fetch_idx", "fetch_valid")

    def local_loss(params, nf, ef, rcv, msk, tgt, req, fidx, fvalid):
        base = spmd.axis_index(mesh, axes) * n_loc
        rcv, fidx = rcv.long(), fidx.long()
        msk, fvalid = msk.to(torch.float32), fvalid.to(torch.float32)
        v = mlp_apply(params["node_enc"], nf)
        e = mlp_apply(params["edge_enc"], ef) * msk[:, None]
        req = req.reshape(n_all, bucket)  # [peer, slot] local node ids, -1 pad
        req_recv = spmd.all_to_all(req.reshape(n_all, 1, bucket), mesh, axes, split_axis=0,
                                   concat_axis=1).reshape(n_all, bucket).long()
        fetch = _halo_fetch(mesh, axes, req_recv, n_all, bucket)

        def layer_fn(lp, v, e):
            resp = fetch(v)
            vs = resp[fidx] * fvalid[:, None]
            vr = v[rcv - base]
            e_new = mlp_apply(lp["edge_mlp"], torch.cat([e, vs, vr], -1))
            e = e + e_new * msk[:, None]
            agg = gnn_lib.segment_sum(e, rcv - base, n_loc)
            v = v + mlp_apply(lp["node_mlp"], torch.cat([v, agg], -1))
            return v, e

        for lp in params["layers"]:
            v, e = spmd.checkpoint(layer_fn, lp, v, e)
        out = mlp_apply(params["decoder"], v)
        return torch.sum(torch.square(out - tgt)), 1.0 / (N * cfg.d_out)

    in_specs = [(axes, None), (axes, None), (axes,), (axes,), (axes, None), (axes, None),
                (axes,), (axes,)]
    step = _sharded_train_step(mesh, axes, local_loss, in_specs, keys)
    return step, (rep, opt_sh, batch_sh), (params_s, opt_s, batch_s)


# ---------------------------------------------------------------------------
# Cell: llama3-405b train_4k (biggest model, memory + collective heavy),
# and grok-1 prefill_32k.
# ---------------------------------------------------------------------------


def _llama_variant(mesh, **overrides):
    cell = cells_mod.lm_cell(dataclasses.replace(llama3_405b.CONFIG, **overrides), "train_4k",
                             mesh)
    return cell.fn, cell.in_shardings, cell.abstract_args


def llama_baseline(mesh):
    return _llama_variant(mesh)


def llama_no_sp(mesh):
    return _llama_variant(mesh, activation_sharding=None)


def llama_mb16(mesh):
    return _llama_variant(mesh, microbatches=16)


def llama_mb4(mesh):
    return _llama_variant(mesh, microbatches=4)


def llama_mb4_no_sp(mesh):
    return _llama_variant(mesh, microbatches=4, activation_sharding=None)


def llama_mb2_no_sp(mesh):
    return _llama_variant(mesh, microbatches=2, activation_sharding=None)


def llama_sp_residual(mesh):
    return _llama_variant(mesh, activation_sharding="seq_residual")


def llama_sp_residual_mb4(mesh):
    return _llama_variant(mesh, activation_sharding="seq_residual", microbatches=4)


def llama_mb4_chunk1024(mesh):
    return _llama_variant(mesh, microbatches=4, attn_chunk=1024)


def llama_mb2_chunk1024(mesh):
    return _llama_variant(mesh, microbatches=2, attn_chunk=1024)


def llama_chunk256(mesh):
    return _llama_variant(mesh, attn_chunk=256)


def llama_chunk1024(mesh):
    return _llama_variant(mesh, attn_chunk=1024)


def grok_prefill_baseline(mesh):
    cell = cells_mod.lm_cell(grok_1_314b.CONFIG, "prefill_32k", mesh)
    return cell.fn, cell.in_shardings, cell.abstract_args


def grok_prefill_grouped(mesh):
    """Fixed-size MoE routing groups bound the GShard dispatch one-hot
    linearly in S."""
    cell = cells_mod.lm_cell(dataclasses.replace(grok_1_314b.CONFIG, moe_group=2048),
                             "prefill_32k", mesh)
    return cell.fn, cell.in_shardings, cell.abstract_args


VARIANTS = {
    "tt_retrieval": {
        "baseline": tt_retrieval_baseline,
        "float_index": tt_retrieval_float_index,
        "bebr_sdc": tt_retrieval_bebr,
        "bebr_sdc_fullmesh": tt_retrieval_bebr_full,
        "bebr_sdc_merge": tt_retrieval_bebr_merge,
    },
    "gnn_ogb": {
        "baseline": gnn_ogb_baseline,
        "node_constrained": gnn_ogb_node_constrained,
        "node_constrained_bf16": gnn_ogb_bf16_edges,
        "partitioned": gnn_ogb_partitioned,
        "partitioned_bf16gather": lambda mesh: gnn_ogb_partitioned(
            mesh, gather_dtype=torch.bfloat16),
        "halo_exchange": gnn_ogb_halo,
        "halo_hostplan": gnn_ogb_halo_hostplan,
    },
    "grok_prefill": {
        "baseline": grok_prefill_baseline,
        "routing_groups": grok_prefill_grouped,
    },
    "llama405b_train": {
        "baseline": llama_baseline,
        "no_seq_sharding": llama_no_sp,
        "microbatch16": llama_mb16,
        "microbatch4": llama_mb4,
        "mb4_no_sp": llama_mb4_no_sp,
        "mb2_no_sp": llama_mb2_no_sp,
        "sp_residual": llama_sp_residual,
        "sp_residual_mb4": llama_sp_residual_mb4,
        "mb4_chunk1024": llama_mb4_chunk1024,
        "mb2_chunk1024": llama_mb2_chunk1024,
        "attn_chunk256": llama_chunk256,
        "attn_chunk1024": llama_chunk1024,
    },
}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_variant(cell: str, variant: str, multi_pod: bool = False) -> dict:
    """The record of one variant on the production mesh (meta leaves, a fake
    process group)."""
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    fn, shardings, abstract = VARIANTS[cell][variant](mesh)
    return _measure(fn, shardings, abstract, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--variant", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="perf_torch_results.json")
    args = ap.parse_args(argv)
    if args.variant not in VARIANTS[args.cell]:
        ap.error(f"--variant of {args.cell} is one of {sorted(VARIANTS[args.cell])}")

    key = f"{args.cell}|{args.variant}|{mesh_name(args.multi_pod)}"
    try:
        res = run_variant(args.cell, args.variant, args.multi_pod)
        print(f"{key}: compute={res['compute_ms']:.2f}ms memory={res['memory_ms']:.2f}ms "
              f"coll={res['collective_ms']:.2f}ms peak={res['peak_gib']:.2f}GiB "
              f"run={res['run_s']}s")
    except Exception as e:  # noqa: BLE001 — recorded, then the exit code says so
        res = {"ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        print(f"{key}: FAILED {res['error']}", file=sys.stderr)

    log = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            log = json.load(f)
    log[key] = res
    with open(args.out, "w") as f:
        json.dump(log, f, indent=1)
    if not res["ok"]:
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
