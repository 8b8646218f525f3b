"""Task-agnostic embedding-to-embedding binarizer training (BEBR §3.2.2-3),
ported from ``repro/core/trainer.py``.

  * the standard step: anchors/positives are float embeddings (two views
    of the same item); the online binarizer encodes anchors, a momentum
    copy encodes positives and queue keys;
  * queue-based global hard negative mining (top-k in a MoCo queue);
  * backward-compatible training (§3.2.3): L + L_BC against a frozen
    phi_old, queue keys encoded by phi_old.

The reference's steps are pure functions of a ``TrainState`` pytree.
Here the state holds the online and momentum encoders as
``RecurrentBinarizer`` modules, and a step updates their parameters and
running statistics in place (the returned ``TrainState`` carries the new
Adam moments, queue and step). ``train_state_to_numpy`` /
``train_state_from_numpy`` convert to and from the reference's tree.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import binarize_lib as B
from repro_torch.core import losses as L
from repro_torch.device import resolve_device
from repro_torch.train import optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    binarizer: B.BinarizerConfig
    queue: L.QueueConfig
    temperature: float = 0.07
    ema_decay: float = 0.999
    adam: optim.AdamConfig = dataclasses.field(
        default_factory=lambda: optim.AdamConfig(lr=0.02, clip_norm=5.0)
    )
    bc_weight: float = 1.0  # weight on L_BC during compatible training
    # BC mining: queue entries this similar to the positive are treated as
    # potential duplicates/same-item views and excluded from negatives
    # (hard negatives at ~0.95 cosine to the positive give contradictory
    # alignment gradients and stall L_BC).
    bc_pos_exclusion: float = 0.85
    # Influence weight (Shen et al. [45]): direct same-item cosine
    # maximisation between phi_new and phi_old codes. The NCE term alone
    # plateaus once the positive clears the mined negatives; the influence
    # term keeps sharpening point-wise alignment past that plateau.
    bc_influence_weight: float = 2.0


class TrainState(NamedTuple):
    model: B.RecurrentBinarizer  # online encoder: params + running statistics
    m_model: B.RecurrentBinarizer  # momentum (key) encoder
    opt_state: optim.AdamState
    queue: Dict[str, Any]
    step: int


class TrainStateArrays(NamedTuple):
    """The reference's ``TrainState`` as numpy arrays: the same fields, so
    ``train/checkpoint.py`` stores it under the reference's keys."""

    params: Any
    bn_state: Any
    m_params: Any
    m_bn_state: Any
    opt_state: optim.AdamState
    queue: Dict[str, np.ndarray]
    step: np.ndarray


def init_train_state(cfg: TrainConfig, key: torch.Tensor, device="cuda") -> TrainState:
    """A fresh state on ``device``: ``init_binarizer`` from ``key`` (the
    reference's ``init_train_state(key, cfg)``), a momentum copy, zero Adam
    moments and an empty queue."""
    device = resolve_device(device)
    model = B.init_binarizer(cfg.binarizer, key, device)
    return TrainState(
        model=model,
        m_model=copy.deepcopy(model),
        opt_state=optim.adam_init(B.param_leaves(model)),
        queue=L.init_queue(cfg.queue, device),
        step=0,
    )


def _encode(model: B.RecurrentBinarizer, f: torch.Tensor, train: bool) -> torch.Tensor:
    return B.binarize(model, f, train=train)[1]


def _assign(model: B.RecurrentBinarizer, leaves: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for k, p in B.param_leaves(model).items():
            p.copy_(leaves[k])


def _apply_grads(state: TrainState, loss: torch.Tensor, queue_keys: torch.Tensor,
                 cfg: TrainConfig):
    """The steps' shared tail: gradients of ``loss`` with respect to the
    online parameters, Adam, the momentum encoder's EMA towards the new
    parameters, and the queue push. Returns (new state, gradients)."""
    params = B.param_leaves(state.model)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    with torch.no_grad():
        new_params, opt_state = optim.adam_update(grads, state.opt_state, params, cfg.adam)
        _assign(state.model, new_params)
        _assign(state.m_model, L.ema_update(new_params, B.param_leaves(state.m_model),
                                            cfg.ema_decay))
    new_state = TrainState(model=state.model, m_model=state.m_model, opt_state=opt_state,
                           queue=L.queue_push(state.queue, queue_keys), step=state.step + 1)
    return new_state, grads


def train_step(
    state: TrainState,
    anchors: torch.Tensor,
    positives: torch.Tensor,
    cfg: TrainConfig,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One emb2emb contrastive step (Eq. 4-5)."""
    # Momentum encoder produces keys (positives + queue refresh), no grad;
    # it runs in train mode, so its running statistics move.
    with torch.no_grad():
        keys_pos = _encode(state.m_model, positives, train=True)
    negatives = L.mine_hard_negatives(state.queue, keys_pos, cfg.queue.top_k,
                                      positives=keys_pos)
    enc = _encode(state.model, anchors, train=True)
    loss = L.info_nce(enc, keys_pos, negatives, temperature=cfg.temperature)
    new_state, grads = _apply_grads(state, loss, keys_pos, cfg)
    return new_state, {"loss": loss.detach(), "grad_norm": optim.global_norm(grads)}


def bc_train_step(
    state: TrainState,
    old: B.RecurrentBinarizer,
    anchors: torch.Tensor,
    positives: torch.Tensor,
    cfg: TrainConfig,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Backward-compatible step (Eq. 9-10): arg min L + L_BC.

    ``anchors`` are embeddings from the (possibly new) backbone phi-tilde;
    ``positives`` are embeddings the *old* stack would see. ``old`` (phi_old)
    is frozen and runs in eval mode; its codes populate the BC queue so new
    queries learn to rank correctly against the historical binary index.
    """
    with torch.no_grad():
        old_pos = _encode(old, positives, train=False)
    old_negatives = L.mine_hard_negatives(
        state.queue, old_pos, cfg.queue.top_k, positives=old_pos,
        pos_exclusion_sim=cfg.bc_pos_exclusion,
    )
    # New-model momentum keys for the self-discrimination term. Self
    # negatives must live in the NEW space (other keys in the batch):
    # mixing old-space negatives into the self softmax would repel the new
    # embedding space away from the old one, fighting L_BC.
    with torch.no_grad():
        new_pos = _encode(state.m_model, positives, train=True)
    n = new_pos.shape[0]
    new_negatives = torch.stack([torch.roll(new_pos, s, dims=0) for s in range(1, min(n, 8))],
                                dim=1)

    enc = _encode(state.model, anchors, train=True)
    l_self = L.info_nce(enc, new_pos, new_negatives, temperature=cfg.temperature)
    l_bc = L.backward_compat_nce(enc, old_pos, old_negatives, temperature=cfg.temperature)
    # influence term: point-wise alignment to the frozen old codes
    enc_u = enc * torch.rsqrt(torch.sum(enc * enc, -1, keepdim=True) + 1e-12)
    old_u = old_pos * torch.rsqrt(torch.sum(old_pos * old_pos, -1, keepdim=True) + 1e-12)
    l_inf = 1.0 - torch.mean(torch.sum(enc_u * old_u, -1))
    total = l_self + cfg.bc_weight * l_bc + cfg.bc_influence_weight * l_inf
    new_state, _ = _apply_grads(state, total, old_pos, cfg)  # queue holds OLD-space keys
    return new_state, {"loss": total.detach(), "loss_self": l_self.detach(),
                       "loss_bc": l_bc.detach()}


# ---------------------------------------------------------------------------
# Conversion to and from the reference's TrainState tree.
# ---------------------------------------------------------------------------


def _tree_leaves(tree, model: B.RecurrentBinarizer, kind: str) -> Dict[str, np.ndarray]:
    """The reference tree ``tree`` (of parameters or statistics) flattened
    to ``param_leaves``/``state_leaves`` keys, ``w`` leaves transposed to
    the modules' layout."""
    out = {}
    for key in (B.param_leaves(model) if kind == "params" else B.state_leaves(model)):
        node = tree
        for part in key.split("/"):
            node = node[int(part)] if part.isdigit() else node[part]
        arr = np.asarray(node, dtype=np.float32)
        out[key] = arr.T if key.endswith("/w") else arr
    return out


def _moments_tree(cfg: B.BinarizerConfig, moments: Dict[str, torch.Tensor]):
    """Adam moments (``param_leaves`` keys and order) as the reference's
    parameter tree of numpy arrays, ``w`` leaves transposed back."""
    arrays = [np.ascontiguousarray(v.detach().cpu().numpy().T if k.endswith("/w")
                                   else v.detach().cpu().numpy()) for k, v in moments.items()]
    return B.nest_leaves(cfg, arrays)[0]


def train_state_to_numpy(state: TrainState) -> TrainStateArrays:
    """The reference's ``TrainState`` tree (``params``, ``bn_state``,
    ``m_params``, ``m_bn_state``, ``opt_state`` (step, mu, nu), ``queue``
    (buf, ptr, filled), ``step``) as numpy arrays, linear weights and their
    moments as ``(d_in, d_out)``, integers as int32."""
    params, bn_state = B.binarizer_to_numpy(state.model)
    m_params, m_bn_state = B.binarizer_to_numpy(state.m_model)
    opt, cfg = state.opt_state, state.model.cfg
    return TrainStateArrays(
        params=params, bn_state=bn_state, m_params=m_params, m_bn_state=m_bn_state,
        opt_state=optim.AdamState(step=np.asarray(opt.step, np.int32),
                                  mu=_moments_tree(cfg, opt.mu), nu=_moments_tree(cfg, opt.nu)),
        queue={"buf": state.queue["buf"].detach().cpu().numpy().copy(),
               "ptr": np.asarray(state.queue["ptr"], np.int32),
               "filled": np.asarray(state.queue["filled"], np.int32)},
        step=np.asarray(state.step, np.int32),
    )


def train_state_from_numpy(tree, cfg: TrainConfig, device="cuda") -> TrainState:
    """A ``TrainState`` on ``device`` from the reference's tree (a
    ``TrainState`` of the reference or a ``TrainStateArrays``, as numpy or
    any array type ``np.asarray`` reads): parameters, statistics, momentum
    copies, Adam moments, queue and step."""
    device = resolve_device(device)
    model = B.binarizer_from_numpy(tree.params, tree.bn_state, cfg.binarizer, device)
    m_model = B.binarizer_from_numpy(tree.m_params, tree.m_bn_state, cfg.binarizer, device)

    def tensors(sub, kind):
        return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                for k, v in _tree_leaves(sub, model, kind).items()}

    opt = tree.opt_state
    queue = tree.queue
    return TrainState(
        model=model,
        m_model=m_model,
        opt_state=optim.AdamState(step=int(np.asarray(opt.step)), mu=tensors(opt.mu, "params"),
                                  nu=tensors(opt.nu, "params")),
        queue={"buf": torch.from_numpy(np.array(queue["buf"], np.float32)).to(device),
               "ptr": int(np.asarray(queue["ptr"])), "filled": int(np.asarray(queue["filled"]))},
        step=int(np.asarray(tree.step)),
    )



def training_progress(initial: Dict[str, torch.Tensor], final: Dict[str, torch.Tensor],
                      losses, window: int = 10) -> Dict[str, Any]:
    """What a training run did, for a check that it trained: whether any
    tensor of ``final`` differs from the one of the same key in ``initial``
    (copies taken before the run), and the mean loss of its first and
    last ``window`` steps (``losses``: one scalar tensor a step), for an
    objective whose loss is comparable across the run."""
    return {"moved": any(not torch.equal(initial[k], t.detach()) for k, t in final.items()),
            "loss_before": float(torch.stack(losses[:window]).mean()),
            "loss_after": float(torch.stack(losses[-window:]).mean()),
            "loss": f"training, first and last {window} steps"}


def held_out_loss(state: TrainState, model: B.RecurrentBinarizer, anchors: torch.Tensor,
                  positives: torch.Tensor, cfg: TrainConfig,
                  old: B.RecurrentBinarizer | None = None) -> float:
    """The contrastive loss (Eq. 4) of ``model`` on pairs it was not trained
    on, every encoder in eval mode and nothing updated: the anchors' codes
    against the positives' keys from ``state``'s momentum encoder and the
    hard negatives its queue gives them (``train_step``'s L), or, given
    ``old``, against phi_old's keys (``bc_train_step``'s L_BC)."""
    with torch.no_grad():
        if old is None:
            keys = B.binarize_eval(state.m_model, positives)
            negatives = L.mine_hard_negatives(state.queue, keys, cfg.queue.top_k, positives=keys)
        else:
            keys = B.binarize_eval(old, positives)
            negatives = L.mine_hard_negatives(state.queue, keys, cfg.queue.top_k, positives=keys,
                                              pos_exclusion_sim=cfg.bc_pos_exclusion)
        return float(L.info_nce(B.binarize_eval(model, anchors), keys, negatives,
                                temperature=cfg.temperature))


def binarizer_progress(state: TrainState, initial: B.RecurrentBinarizer, anchors: torch.Tensor,
                       positives: torch.Tensor, cfg: TrainConfig,
                       old: B.RecurrentBinarizer | None = None) -> Dict[str, Any]:
    """``training_progress`` for a binarizer, whose training loss is not
    comparable across a run (the queue fills and its negatives harden, so
    it rises while the model learns): whether the weights moved from
    ``initial`` (a copy taken before the run), and ``held_out_loss`` of
    ``initial`` and of the trained model on the same held-out pairs, keys
    and negatives."""
    moved = any(not torch.equal(p0, p) for p0, p in zip(initial.parameters(),
                                                        state.model.parameters()))
    return {"moved": moved,
            "loss_before": held_out_loss(state, initial, anchors, positives, cfg, old),
            "loss_after": held_out_loss(state, state.model, anchors, positives, cfg, old),
            "loss": "held-out pairs, initial and trained weights"}
