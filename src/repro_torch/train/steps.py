"""Step builders (ports ``repro/train/steps.py``): the model zoo's train
and serve steps (LM, GNN and recsys).

A parameter tree is the reference's pytree layout in dictionaries and
lists of tensors. A train step is ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: gradients (accumulated over microbatches
in the reference's order), the global norm, clipping and Adam
(``optim.adam_update_``, the reference's arithmetic in place: the tables
of dlrm-rm2 and two-tower do not fit a second copy beside their
moments), so it updates ``params`` and ``opt_state``'s moments in place
and returns them. ``opt_state`` is an ``optim.AdamState`` over
``checkpoint.flatten_tree(params)``'s keys; ``train_state_tree`` gives
the reference's ``(params, AdamState)`` tree for ``train/checkpoint.py``.

Retrieval top-k is the stable sort (``ops.select_topk``): ties go to the
lower id, as ``jax.lax.top_k`` orders them. Serve, prefill and decode
steps run without recording gradients; the binarizer's steps are in
``core/trainer.py``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.core.binarize_lib import SDC_NEG_INF, sdc_affine_epilogue
from repro_torch.device import full_fp32_matmul, is_dtensor
from repro_torch.kernels.sdc.ref import code_dot
from repro_torch.kernels.sdc.sdc import sdc_topk, select_topk
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import dien as dien_lib
from repro_torch.models.recsys import dlrm as dlrm_lib
from repro_torch.models.recsys import mind as mind_lib
from repro_torch.models.recsys import two_tower as tt_lib
from repro_torch.models.recsys.embedding import embedding_lookup
from repro_torch.train import optim
from repro_torch.train.checkpoint import flatten_tree, unflatten_tree


def init_opt_state(params) -> optim.AdamState:
    """Zero Adam moments over the leaves of ``params`` (``flatten_tree``'s keys)."""
    return optim.adam_init(flatten_tree(params))


def train_state_tree(params, opt_state: optim.AdamState):
    """``(params, AdamState(step, mu, nu))`` in the reference's layout, the
    tree its launcher checkpoints (the step as an int32 scalar)."""
    return (params, optim.AdamState(step=np.asarray(opt_state.step, np.int32),
                                    mu=unflatten_tree(params, opt_state.mu.values()),
                                    nu=unflatten_tree(params, opt_state.nu.values())))


def train_state_from_tree(tree) -> Tuple[Any, optim.AdamState]:
    """The inverse of ``train_state_tree`` (e.g. on what ``checkpoint.restore`` returns)."""
    params, opt = tree
    return params, optim.AdamState(step=int(np.asarray(opt.step)), mu=flatten_tree(opt.mu),
                                   nu=flatten_tree(opt.nu))


def _value_and_grad(loss_fn, params, batch):
    flat = flatten_tree(params)
    leaves = [t.detach().requires_grad_(True) for t in flat.values()]
    loss = loss_fn(unflatten_tree(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), dict(zip(flat, grads))


def _accumulate_grads(loss_fn, params, batch, microbatches: int):
    """Gradient accumulation. ``batch`` is a dictionary whose tensors have
    a leading global-batch dim divisible by ``microbatches``; the sums run
    in the reference's order (zeros, then each microbatch in turn, the
    loss first and then the gradients leaf by leaf), then times
    1 / microbatches."""
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch)
    n = next(iter(batch.values())).shape[0] // microbatches
    loss_acc = None
    counter = _loop_counter(batch)
    # on meta tensors under a cost counter the trips after the first have the
    # same shapes and layouts: the second runs once and counts for all of them
    for i in range(microbatches) if counter is None else [0, 1]:
        trips = 1 if counter is None or i == 0 else microbatches - 1
        with _each_trip(counter, trips):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss, grads = _value_and_grad(loss_fn, params, mb)
            if loss_acc is None:
                loss_acc = torch.zeros((), dtype=torch.float32, device=loss.device)
                grad_acc = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                            for k, g in grads.items()}
            loss_acc = loss_acc + loss
            grad_acc = {k: grad_acc[k] + grads[k] for k in grad_acc}
        del grads
    inv = 1.0 / microbatches
    return loss_acc * inv, {k: g * inv for k, g in grad_acc.items()}


def _loop_counter(batch):
    """The active cost counter (``launch/hlo_cost``) that counts a loop's
    body once times its trip count, when ``batch``'s tensors are meta tensors
    (no values, every microbatch alike); else None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    leaves = [v for v in batch.values() if isinstance(v, torch.Tensor)]
    if not leaves or any(_local(v).device.type != "meta" for v in leaves):
        return None
    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "counts_loops", False):
            return mode
    return None


def _local(t):
    return t._local_tensor if is_dtensor(t) else t


def _each_trip(counter, trips: int):
    """What runs inside counts once for each of ``trips`` (the counter's
    ``repeat``); nothing when there is no counter or one trip."""
    return contextlib.nullcontext() if counter is None or trips == 1 else counter.repeat(trips)


def make_train_step(loss_fn: Callable, adam_cfg: optim.AdamConfig, microbatches: int = 1):
    """Generic ``(params, opt_state, batch) -> (params, opt_state, metrics)``,
    ``params`` and the moments updated in place."""

    def step(params, opt_state, batch):
        loss, grads = _accumulate_grads(loss_fn, params, batch, microbatches)
        norm = optim.global_norm(grads)
        opt_state = optim.adam_update_(grads, opt_state, flatten_tree(params), adam_cfg,
                                       norm=norm)
        return params, opt_state, {"loss": loss, "grad_norm": norm}

    return step


# ---------------------------------------------------------------------------
# LM family.
# ---------------------------------------------------------------------------


def lm_train_step(cfg: tf.TransformerConfig, adam_cfg: optim.AdamConfig, constrain=None):
    """Next-token cross-entropy (+ 0.01 x the MoE aux loss), accumulated
    over ``cfg.microbatches``."""

    def loss_fn(params, batch):
        return tf.lm_loss(params, batch["tokens"], batch["labels"], cfg, constrain=constrain)

    return make_train_step(loss_fn, adam_cfg, cfg.microbatches)


def lm_prefill_step(cfg: tf.TransformerConfig):
    """``step(params, batch) -> last-position logits [B, V]`` (batch["tokens"] [B, S])."""

    def step(params, batch):
        with torch.no_grad():
            return tf.prefill(params, batch["tokens"], cfg)

    return step


def lm_decode_step(cfg: tf.TransformerConfig):
    """``step(params, batch, cache) -> (logits [B, V], cache)`` for
    batch["token"] [B]; the cache is written in place (``tf.decode_step``)."""

    def step(params, batch, cache):
        with torch.no_grad():
            return tf.decode_step(params, batch["token"], cache, cfg)

    return step


# ---------------------------------------------------------------------------
# GNN family.
# ---------------------------------------------------------------------------


def gnn_train_step(cfg: gnn_lib.GNNConfig, adam_cfg: optim.AdamConfig, microbatches: int = 1,
                   node_constrain=None):
    """Masked MSE over the nodes; a graph batch is not split along its
    edges, so ``microbatches`` is ignored, as in the reference."""

    def loss_fn(params, batch):
        return gnn_lib.mse_loss(params, batch["node_feat"], batch["edge_feat"], batch["senders"],
                                batch["receivers"], batch["targets"],
                                node_mask=batch.get("node_mask"),
                                edge_mask=batch.get("edge_mask"), cfg=cfg,
                                node_constrain=node_constrain)

    return make_train_step(loss_fn, adam_cfg, 1)


def gnn_infer_step(cfg: gnn_lib.GNNConfig):
    """``step(params, batch) -> per-node outputs [N, d_out]``."""

    def step(params, batch):
        with torch.no_grad():
            return gnn_lib.forward(params, batch["node_feat"], batch["edge_feat"],
                                   batch["senders"], batch["receivers"],
                                   edge_mask=batch.get("edge_mask"), cfg=cfg)

    return step


# ---------------------------------------------------------------------------
# RecSys family.
# ---------------------------------------------------------------------------


def dlrm_train_step(cfg: dlrm_lib.DLRMConfig, adam_cfg, microbatches=1):
    def loss_fn(params, batch):
        return dlrm_lib.bce_loss(params, batch["dense"], batch["sparse_ids"], batch["labels"],
                                 cfg)

    return make_train_step(loss_fn, adam_cfg, microbatches)


def dlrm_serve_step(cfg: dlrm_lib.DLRMConfig):
    """``step(params, batch) -> logits [B]`` over the reference's parameter
    tree (``dlrm_lib.forward``), as the other serve steps take theirs; a
    tree whose shapes are not ``cfg``'s raises ValueError."""

    def step(params, batch):
        dlrm_lib.check_tree(params, cfg)
        with torch.no_grad():
            return dlrm_lib.forward(params, batch["dense"], batch["sparse_ids"], cfg)

    return step


def tt_train_step(cfg: tt_lib.TwoTowerConfig, adam_cfg, microbatches=1):
    def loss_fn(params, batch):
        return tt_lib.sampled_softmax_loss(params, batch["hist_ids"], batch["hist_mask"],
                                           batch["pos_items"], batch["item_logq"], cfg)

    return make_train_step(loss_fn, adam_cfg, microbatches)


def tt_serve_step(cfg: tt_lib.TwoTowerConfig):
    def step(params, batch):
        with torch.no_grad():
            return tt_lib.score_candidates(params, batch["hist_ids"], batch["hist_mask"],
                                           batch["cand_ids"], cfg)

    return step


def tt_retrieval_step(cfg: tt_lib.TwoTowerConfig, k: int = 100):
    """retrieval_cand: embed the queries, score the candidates, top-k
    (scores [B, k], ids [B, k] int32 into ``cand_ids``)."""
    serve = tt_serve_step(cfg)

    def step(params, batch):
        return select_topk(serve(params, batch), k)

    return step


def _sign(x):
    return torch.where(x > 0, 1.0, -1.0)


def _unit(f):
    return f * torch.rsqrt(torch.sum(f * f, -1, keepdim=True) + 1e-12)


def _total_order(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in IEEE total order (-0.0 below +0.0), the
    order in which ``jax.lax.top_k`` ranks scores."""
    bits = v.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """The top ``k`` of candidates ``scores`` [n] f32 with distinct ``ids``
    [n] int32 as ``jax.lax.top_k`` ranks them (score descending in total
    order, ties to the lower id), as ([1, k], [1, k]); fewer than ``k``
    candidates are padded with SDC_NEG_INF and id -1."""
    order = torch.sort(ids, stable=True).indices
    scores, ids = scores[order], ids[order]
    order = torch.sort(_total_order(scores), descending=True, stable=True).indices[:k]
    scores, ids = scores[order], ids[order]
    pad = k - scores.shape[0]
    if pad > 0:
        scores = torch.cat([scores, scores.new_full((pad,), SDC_NEG_INF)])
        ids = torch.cat([ids, ids.new_full((pad,), -1)])
    return scores[None], ids[None]


def binarize_linear(bparams, f: torch.Tensor, n_levels: int) -> torch.Tensor:
    """The reference's linear recurrent binarization of embeddings ``f``
    [B, d] with ``bparams`` (W [levels] of [d, code_dim], R [levels - 1]
    of [code_dim, d]): integer codes as f32 [B, code_dim]."""
    f = _unit(f)
    b = _sign(f @ bparams["W"][0])
    acc = b
    code = (b + 1.0) * 0.5 * (2 ** (n_levels - 1))
    for t in range(n_levels - 1):
        recon = _unit(acc @ bparams["R"][t])
        r = _sign((f - recon) @ bparams["W"][t + 1])
        acc = acc + (2.0 ** -(t + 1)) * r
        code = code + (r + 1.0) * 0.5 * (2 ** (n_levels - 2 - t))
    return code


def tt_retrieval_bebr_step(cfg: tt_lib.TwoTowerConfig, k: int = 100, code_dim: int = 64,
                           n_levels: int = 4):
    """BEBR-optimised retrieval: the query embeds through the tower,
    binarizes with the linear recurrent binarizer (the reference's
    ``binarize_linear``) and is scored against precomputed integer codes
    by ``sdc_topk``: the CUDA kernel on the card, its plain version on the
    CPU, both with the reference's epilogue (a^2) dot + (a beta)(sum c_q +
    sum c_d) + C beta^2, then times the inverse norm.

    batch: hist_ids/hist_mask (one query), cand_codes [N, code_dim] int8,
    cand_inv [N] f32. Every candidate competes, as in the reference, which
    scores without a kernel: ``sdc_topk`` excludes a candidate whose
    inverse norm is not > 0, so those rows are scored here in plain torch
    (the exact integer parts, the same epilogue, times their inverse norm:
    0 for 0, the sign flipped for a negative value) and merged with the
    kernel's k by ``jax.lax.top_k``'s order (``sdc_topk_every_row``; on
    meta tensors and DTensors the kernel's result alone).
    ``params["binarizer"]``: W [levels] of [emb_out, code_dim] and R
    [levels - 1] of [code_dim, emb_out]. Returns (scores [1, k], ids [1, k]).
    """

    def step(params, batch):
        full_fp32_matmul()
        with torch.no_grad():
            q = tt_lib.query_embed(params, batch["hist_ids"], batch["hist_mask"], cfg)
            if q.shape[0] != 1:
                raise ValueError(f"the BEBR step scores one query, got {q.shape[0]}")
            q_code = binarize_linear(params["binarizer"], q, n_levels)
            if q_code.shape[1] != code_dim:
                raise ValueError(f"binarizer gives {q_code.shape[1]} dims, step built for "
                                 f"{code_dim}")
            codes, inv = batch["cand_codes"], batch["cand_inv"]
            if not is_dtensor(codes):
                codes = torch.as_tensor(codes, device=q.device).contiguous()
                inv = torch.as_tensor(inv, dtype=torch.float32, device=q.device).contiguous()
            return sdc_topk_every_row(q_code.to(torch.int8), codes, inv, n_levels=n_levels, k=k)

    return step


def sdc_topk_every_row(q8: torch.Tensor, codes: torch.Tensor, inv: torch.Tensor, *,
                       n_levels: int, k: int):
    """Top ``k`` of one query ``q8`` [1, D] int8 over every row of ``codes``
    [N, D] int8 with inverse norms ``inv`` [N], as the reference scores them
    (no row excluded): ``sdc_topk``, whose kernel excludes a row whose
    inverse norm is not > 0, then those rows scored in plain torch (the
    exact integer parts, the same epilogue, times their inverse norm: 0 for
    0, the sign flipped for a negative value) and merged with the kernel's
    k in ``jax.lax.top_k``'s order (``_merge_topk``). Finding whether there
    are such rows reads the device once a call.

    On meta tensors and DTensors (a dry run, ``launch/hlo_cost``) nothing
    can be read: the result is ``sdc_topk``'s alone, as if no row had an
    inverse norm <= 0."""
    vals, ids = sdc_topk(q8, codes, inv, n_levels=n_levels, k=k)
    if is_dtensor(codes) or codes.device.type == "meta":
        return vals, ids
    off = torch.nonzero(~(inv > 0)).flatten()
    if off.numel() == 0:
        return vals, ids
    rows = codes[off]
    off_scores = sdc_affine_epilogue(
        code_dot(q8, rows)[0], q8.to(torch.int32).sum() + rows.to(torch.int32).sum(-1),
        dim=q8.shape[1], n_levels=n_levels, inv_norm=inv[off])
    keep = ids[0] >= 0
    return _merge_topk(torch.cat([vals[0][keep], off_scores]),
                       torch.cat([ids[0][keep], off.to(torch.int32)]), k)


def mind_train_step(cfg: mind_lib.MINDConfig, adam_cfg, microbatches=1):
    def loss_fn(params, batch):
        return mind_lib.label_aware_loss(params, batch["hist_ids"], batch["hist_mask"],
                                         batch["pos_items"], batch["neg_items"], cfg)

    return make_train_step(loss_fn, adam_cfg, microbatches)


def mind_serve_step(cfg: mind_lib.MINDConfig):
    def step(params, batch):
        with torch.no_grad():
            return mind_lib.serve_interests(params, batch["hist_ids"], batch["hist_mask"], cfg)

    return step


def mind_retrieval_step(cfg: mind_lib.MINDConfig, k: int = 100):
    """Multi-interest retrieval: max-over-interests candidate scoring, top-k."""
    serve = mind_serve_step(cfg)

    def step(params, batch):
        full_fp32_matmul()
        caps = serve(params, batch)  # [B, K, D]
        with torch.no_grad():
            cand = embedding_lookup(params["item_table"], batch["cand_ids"])
            scores = torch.einsum("bkd,nd->bkn", caps, cand).amax(dim=1)
        return select_topk(scores, k)

    return step


def dien_train_step(cfg: dien_lib.DIENConfig, adam_cfg, microbatches=1):
    def loss_fn(params, batch):
        return dien_lib.bce_loss(params, batch["hist_items"], batch["hist_cates"],
                                 batch["hist_mask"], batch["target_item"], batch["target_cate"],
                                 batch["labels"], cfg)

    return make_train_step(loss_fn, adam_cfg, microbatches)


def dien_serve_step(cfg: dien_lib.DIENConfig):
    def step(params, batch):
        with torch.no_grad():
            return dien_lib.forward(params, batch["hist_items"], batch["hist_cates"],
                                    batch["hist_mask"], batch["target_item"],
                                    batch["target_cate"], cfg)

    return step

