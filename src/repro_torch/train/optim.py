"""Adam with global-norm gradient clipping, and learning-rate schedules
(ports ``repro/train/optim.py``).

The reference's own expression, not ``torch.optim.Adam``'s: clip by
``min(1, max_norm / (norm + 1e-12))``, bias corrections ``1 - b**step``
in float32, then ``mhat / (sqrt(vhat) + eps)``. A tree here is a
dictionary of tensors whose order is the reference's tree-leaf order
(``binarize_lib.param_leaves``), so the global norm sums its leaves as the
reference does. ``adam_update_`` overwrites the parameters, the moments
and (when clipping) the gradients in place, as the model zoo's train
steps need (``train/steps.py``); ``adam_update`` runs the same arithmetic
on copies and returns new tensors, for the binarizer's trainer
(``core/trainer.py``), which keeps the old parameters beside the new. The
step count and the schedules live on the host, so no step reads the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import is_dtensor

Tree = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 0.02  # paper's initial LR for binarizer training
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # >0 => AdamW (decoupled)
    clip_norm: float = 5.0  # paper: clip when grad norm exceeds 5
    # step -> float32 learning-rate multiplier. Its repr holds the closure's
    # address, so a config with a schedule digests anew in every process
    # (the reference's binarizer cache never hits for one either).
    schedule: Optional[Callable[[int], np.float32]] = None


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in the tree's order."""
    total = 0
    for leaf in tree.values():
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tree:
    norm = global_norm(tree)
    # a true division (``max_norm / tensor`` would multiply by a reciprocal)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}


def adam_init(params: Tree) -> AdamState:
    # f32 accumulators regardless of param dtype (bf16 moments diverge).
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamState(step=0, mu=zeros, nu={k: z.clone() for k, z in zeros.items()})


def adam_update(grads: Tree, state: AdamState, params: Tree,
                cfg: AdamConfig) -> tuple[Tree, AdamState]:
    """Returns (new_params, new_state): ``adam_update_`` on copies."""
    new_p = {k: p.detach().clone() for k, p in params.items()}
    copy = AdamState(step=state.step, mu={k: m.clone() for k, m in state.mu.items()},
                     nu={k: v.clone() for k, v in state.nu.items()})
    clipped = {k: g.detach().clone() for k, g in grads.items()}
    return new_p, adam_update_(clipped, copy, new_p, cfg)


def adam_update_(grads: Tree, state: AdamState, params: Tree, cfg: AdamConfig,
                 norm: Optional[torch.Tensor] = None, chunk: int = 1 << 26) -> AdamState:
    """Adam in place: the parameters, the moments and (when clipping) the
    gradients are overwritten, ``chunk`` elements of a leaf at a time
    (elementwise ops, so the chunk changes no bit; a leaf that is not
    contiguous goes in one piece). The model zoo's tables
    need it: dlrm-rm2's are 6.98 GB, and new moments and parameters beside
    the old ones would not fit with the temporaries. ``norm`` is
    ``global_norm(grads)`` when the caller already has it. Returns the new
    state (the same moment tensors, the step advanced).
    """
    with torch.no_grad():
        if cfg.clip_norm and cfg.clip_norm > 0:
            norm = global_norm(grads) if norm is None else norm
            scale = torch.clamp(torch.full_like(norm, cfg.clip_norm) / (norm + 1e-12), max=1.0)
            for g in grads.values():
                g.mul_(scale.to(g.dtype))
        step = state.step + 1
        lr = cfg.lr if cfg.schedule is None else float(np.float32(cfg.lr) * cfg.schedule(step))
        bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
        bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
        for k, p in params.items():
            leaf = [p.detach(), grads[k], state.mu[k], state.nu[k]]
            if all(t.is_contiguous() and not is_dtensor(t) for t in leaf):
                flat = [t.view(-1) for t in leaf]
                parts = [[t[s:s + chunk] for t in flat] for s in range(0, flat[0].numel(), chunk)]
            else:  # a strided leaf, or a DTensor's (each rank its own piece), in one piece
                parts = [leaf]
            for p_, g_, m_, v_ in parts:
                g32 = g_.to(torch.float32)
                m = cfg.b1 * m_ + (1 - cfg.b1) * g32
                v = cfg.b2 * v_ + (1 - cfg.b2) * torch.square(g32)
                delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                if cfg.weight_decay > 0:
                    delta = delta + cfg.weight_decay * p_.to(torch.float32)
                p_.copy_((p_.to(torch.float32) - lr * delta).to(p_.dtype))
                m_.copy_(m)
                v_.copy_(v)
    return AdamState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# Schedules: step -> float32 multiplier, computed on the host in float32.
# ---------------------------------------------------------------------------


def cosine_schedule(total_steps: int, warmup: int = 0, floor: float = 0.0):
    def sched(step):
        s = np.float32(step)
        warm = np.minimum(s / np.float32(max(warmup, 1)), np.float32(1.0))
        prog = np.clip((s - np.float32(warmup)) / np.float32(max(total_steps - warmup, 1)),
                       np.float32(0.0), np.float32(1.0))
        cos = np.float32(floor) + np.float32(1 - floor) * np.float32(0.5) * (
            np.float32(1) + np.cos(np.float32(np.pi) * prog))
        return np.float32(warm if s < warmup else cos)

    return sched


def constant_schedule():
    return lambda step: np.float32(1.0)
