"""Adam with global-norm gradient clipping, and learning-rate schedules
(ports ``repro/train/optim.py``).

The reference's own expression, not ``torch.optim.Adam``'s: clip by
``min(1, max_norm / (norm + 1e-12))``, bias corrections ``1 - b**step``
in float32, then ``mhat / (sqrt(vhat) + eps)``. A tree here is a
dictionary of tensors whose order is the reference's tree-leaf order
(``binarize_lib.param_leaves``), so the global norm sums its leaves as the
reference does. Every function returns new tensors; the step count and
the schedules live on the host, so no step reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

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
    """Returns (new_params, new_state)."""
    if cfg.clip_norm and cfg.clip_norm > 0:
        grads = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cfg.lr if cfg.schedule is None else float(np.float32(cfg.lr) * cfg.schedule(step))
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m = cfg.b1 * state.mu[k] + (1 - cfg.b1) * g32
        v = cfg.b2 * state.nu[k] + (1 - cfg.b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.detach().to(torch.float32) - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamState(step=step, mu=new_m, nu=new_v)


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
