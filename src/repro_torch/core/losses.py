"""Contrastive objectives for embedding-to-embedding binarizer training
(ports ``repro/core/losses.py``).

The paper's Eq. (4)/(5): NCE over cosine similarity of recurrent binary
embeddings, with a MoCo-style momentum queue and top-k hardest negative
mining, plus the backward-compatible loss of Eq. (10). The queue is a
dictionary of a device buffer and two host integers, and every function
here returns new tensors, as the reference's pure functions do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device


def _unit(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + eps)


def cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise cosine similarity matrix [A, B]."""
    return _unit(a, eps) @ _unit(b, eps).t()


def info_nce(
    anchors: torch.Tensor,
    positives: torch.Tensor,
    negatives: torch.Tensor,
    *,
    temperature: float = 0.07,
) -> torch.Tensor:
    """NCE loss (Eq. 4) with explicit negatives.

    Args:
      anchors:   [B, m] binary (or float) embeddings of phi(f).
      positives: [B, m] embeddings of phi(k_plus), row-aligned with anchors.
      negatives: [B, K, m] per-anchor negative embeddings kappa(Q).
    """
    ua = _unit(anchors)
    pos = torch.sum(ua * _unit(positives), dim=-1, keepdim=True)  # [B, 1]
    neg = torch.einsum("bm,bkm->bk", ua, _unit(negatives))  # [B, K]
    logits = torch.cat([pos, neg], dim=-1) / temperature
    return -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])


# ---------------------------------------------------------------------------
# Momentum queue with top-k hard-negative mining (Eq. 5).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    length: int  # L, ~16x batch
    dim: int  # m (code_dim of the binarizer output)
    top_k: int  # hardest negatives per anchor


def init_queue(cfg: QueueConfig, device="cuda") -> Dict:
    """The queue stores momentum-encoded binary embeddings.

    ``buf`` [L, dim] float32 on ``device``; ``ptr`` (next slot) and
    ``filled`` (valid rows, so cold-start batches do not mine garbage)
    are host integers, so no step reads the device for them.
    """
    return {
        "buf": torch.zeros((cfg.length, cfg.dim), dtype=torch.float32,
                           device=resolve_device(device)),
        "ptr": 0,
        "filled": 0,
    }


def queue_push(queue: Dict, batch: torch.Tensor) -> Dict:
    """FIFO push of a batch (oldest entries overwritten); a new queue."""
    length = queue["buf"].shape[0]
    bsz = batch.shape[0]
    idx = (queue["ptr"] + torch.arange(bsz, device=batch.device)) % length
    return {
        "buf": queue["buf"].index_copy(0, idx, batch.to(queue["buf"].dtype)),
        "ptr": (queue["ptr"] + bsz) % length,
        "filled": min(queue["filled"] + bsz, length),
    }


def mine_hard_negatives(
    queue: Dict,
    anchors: torch.Tensor,
    top_k: int,
    *,
    positives: Optional[torch.Tensor] = None,
    pos_exclusion_sim: float = 0.999,
) -> torch.Tensor:
    """kappa(Q): top-k highest-cosine queue entries per anchor.

    Entries nearly identical to the anchor's positive (cosine strictly
    above ``pos_exclusion_sim``) are excluded to avoid false negatives.
    Unfilled and excluded rows score -inf; ties go to the lower row, as
    ``jax.lax.top_k`` breaks them (a stable sort), so a cold queue mines
    rows 0..top_k-1 (zero vectors).

    Returns [B, top_k, dim].
    """
    buf = queue["buf"]
    sims = cosine(anchors, buf)  # [B, L]
    valid = torch.arange(buf.shape[0], device=buf.device) < queue["filled"]
    neg_inf = torch.full((), float("-inf"), dtype=sims.dtype, device=sims.device)
    sims = torch.where(valid[None, :], sims, neg_inf)
    if positives is not None:
        pos_sims = cosine(positives, buf)
        sims = torch.where(pos_sims > pos_exclusion_sim, neg_inf, sims)
    _, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return buf[idx[:, :top_k]]


# ---------------------------------------------------------------------------
# Momentum (EMA) parameter update for the key encoder.
# ---------------------------------------------------------------------------


def ema_update(online_params: Dict[str, torch.Tensor], momentum_params: Dict[str, torch.Tensor],
               decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """``decay * m + (1 - decay) * o`` for every leaf of ``momentum_params``."""
    return {k: decay * m + (1.0 - decay) * online_params[k] for k, m in momentum_params.items()}


# ---------------------------------------------------------------------------
# Backward-compatible NCE (Eq. 10): new anchors vs old-encoded keys.
# ---------------------------------------------------------------------------


def backward_compat_nce(
    new_anchors: torch.Tensor,
    old_positives: torch.Tensor,
    old_negatives: torch.Tensor,
    *,
    temperature: float = 0.07,
) -> torch.Tensor:
    """L_BC — identical form to info_nce but keys come from phi_old."""
    return info_nce(new_anchors, old_positives, old_negatives, temperature=temperature)
