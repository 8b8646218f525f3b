"""Gather-then-rerank: score coarse-scan survivors on full-level codes
(ports ``repro/kernels/sdc/rerank.py``).

The bi-granular search mode splits a query into a cheap coarse scan over
level-prefix codes (hot tier) and a sparse fine rerank of the top-k'
survivors against the full-level codes (cold tier). This module is the
fine half: given survivor doc ids, score exactly those rows of the full
corpus through the shared SDC epilogue and return the true top-k.

Every path rides the gather search (``kernels/sdc/gather``): the CUDA
``sdc_gather_topk`` kernel on CUDA tensors, its plain version on CPU
tensors or with ``backend="torch"``. A device-resident fine tier is
viewed as N inverted lists of one row, with the survivors as the probe
table and a mask for the empty slots (``sdc_rerank``); a numpy tier
(``np.memmap`` included) stays on the host, and only the survivors' rows
are gathered there and uploaded as lists of ``group`` rows
(``sdc_rerank_gathered``). The gather breaks ties by slot, so every path
presents the candidates in ascending-id order (``_sort_candidates``),
the column order of a flat scan: a rerank is bit-identical to a
full-level flat scan restricted to the same candidate ids, ties
included, whatever the layout.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sdc import ref as sdc_ref
from repro_torch.kernels.sdc.defaults import RERANK_GROUP, BlockPlan
from repro_torch.kernels.sdc.gather import sdc_gather_topk, sdc_gather_topk_torch
from repro_torch.kernels.sdc.ops import resolve_backend
from repro_torch import spans

_INT32_MAX = np.iinfo(np.int32).max


def fine_inv_norms(codes, n_levels: int, chunk: int = 65536, device="cuda"):
    """Full-level reciprocal doc norms for a (possibly cold) fine tier.

    Numpy fine codes (``np.memmap`` included) are streamed to ``device``
    ``chunk`` rows at a time, so the build never holds the whole cold
    tier there; each chunk goes through the same ``doc_inv_norms`` the
    hot paths use, so the values are bit-identical to a single-shot
    computation. Returns numpy for numpy codes; a tensor passes straight
    through ``doc_inv_norms`` on its own device.
    """
    if not isinstance(codes, np.ndarray):
        return sdc_ref.doc_inv_norms(codes, n_levels)
    dev = resolve_device(device)
    out = np.empty(codes.shape[0], np.float32)
    for i in range(0, codes.shape[0], chunk):
        block = torch.from_numpy(np.array(codes[i:i + chunk])).to(dev)
        out[i:i + chunk] = sdc_ref.doc_inv_norms(block, n_levels).cpu().numpy()
    return out


def _sort_candidates(cand_ids) -> torch.Tensor:
    """Ascending-id candidate order [Q, k'] int32, invalid (< 0) slots last, as -1.

    A flat scan scores documents in id order and breaks score ties toward
    the smaller id; presenting the candidates in that order is what makes
    a rerank bit-identical to a restricted flat scan through ties.
    Candidate ids must be distinct per query (a coarse top-k' is).
    """
    ids = torch.as_tensor(cand_ids).to(torch.int32)
    key = torch.where(ids < 0, _INT32_MAX, ids)
    key = torch.sort(key, dim=-1).values
    return torch.where(key == _INT32_MAX, -1, key)


def _one_row_lists(fine_codes, fine_inv_norm, cand_ids):
    """The fine corpus as N lists of one row, the sorted survivors as the
    probe table, and the mask [Q, k', 1] of the live slots."""
    N = fine_codes.shape[0]
    cand = _sort_candidates(cand_ids)
    lists_codes = fine_codes.reshape(N, 1, fine_codes.shape[-1])
    lists_inv = fine_inv_norm.reshape(N, 1)
    lists_ids = torch.arange(N, dtype=torch.int32, device=fine_codes.device).reshape(N, 1)
    mask = (cand >= 0).to(torch.float32)[..., None]
    return lists_codes, lists_inv, lists_ids, cand, mask


def sdc_rerank(q_codes, fine_codes, fine_inv_norm, cand_ids, *, n_levels: int, k: int,
               packed: bool = False):
    """Rerank survivor ids against a device-resident full-level tier.

    Args:
      q_codes: [Q, D] int8 full-level query codes (unpacked).
      fine_codes: [N, D] int8 full-level corpus codes, or nibble-packed
        uint8 [N, D//2] when ``packed`` (n_levels <= 4).
      fine_inv_norm: [N] f32 reciprocal doc norms at ``n_levels``.
      cand_ids: [Q, k'] integer survivor doc ids from the coarse scan
        (distinct per query; -1 marks an empty slot). k' may be < k.

    Returns:
      (scores [Q, k], ids [Q, k]); slots beyond the valid survivors are
      (SDC_NEG_INF, -1).

    The fine corpus goes to ``gather.sdc_gather_topk`` as N lists of one
    row with the sorted survivors as probes: the kernel on CUDA tensors
    (``sdc_gather_topk.launches`` counts it), the plain version on CPU
    tensors. Probes are clamped into range, so an empty slot reads doc 0
    and only the mask excludes it.
    """
    lists_codes, lists_inv, lists_ids, cand, mask = _one_row_lists(fine_codes, fine_inv_norm,
                                                                   cand_ids)
    return sdc_gather_topk(q_codes, lists_codes, lists_inv, lists_ids, cand, n_levels=n_levels,
                           k=k, packed=packed, cand_mask=mask)


def sdc_rerank_torch(q_codes, fine_codes, fine_inv_norm, cand_ids, *, n_levels: int, k: int,
                     packed: bool = False):
    """Plain PyTorch twin of ``sdc_rerank`` (the reference's
    ``sdc_rerank_xla``), on any device: the same layout through
    ``sdc_gather_topk_torch``, so the same bits."""
    lists_codes, lists_inv, lists_ids, cand, mask = _one_row_lists(fine_codes, fine_inv_norm,
                                                                   cand_ids)
    return sdc_gather_topk_torch(q_codes, lists_codes, lists_inv, lists_ids, cand,
                                 n_levels=n_levels, k=k, packed=packed, cand_mask=mask)


def host_gathered_lists(fine_codes: np.ndarray, fine_inv_norm: np.ndarray, cand_ids, *,
                        group: int, device):
    """The survivors' rows of a host tier as candidate lists on ``device``.

    The sorted candidates [Q, k'] come to the host, are padded with empty
    slots to a multiple of ``g = min(group, k')``, and their rows are
    gathered there (the only reads of the tier). Returns ``(lists_codes
    [Q * k' / g, g, D(/2)], lists_inv [.., g], lists_ids [.., g],
    probes [Q, k' / g])`` on ``device``: an identity probe table, empty
    slots with inverse norm 0 and id -1. While spans are recorded
    (``repro_torch/spans.py``), ``rerank.host`` times the host's part: from the
    candidates' arrival to the last upload issued.
    """
    cand = _sort_candidates(cand_ids).cpu().numpy()
    t0 = time.perf_counter_ns() if spans.on else None
    Q, kp = cand.shape
    g = max(1, min(int(group), kp))
    pad = (-kp) % g
    if pad:
        cand = np.concatenate([cand, -np.ones((Q, pad), np.int32)], axis=1)
        kp += pad
    N = fine_codes.shape[0]
    safe = np.clip(cand, 0, N - 1)
    g_codes = fine_codes[safe]  # [Q, k', D(/2)]
    g_inv = np.where(cand >= 0, np.asarray(fine_inv_norm)[safe], 0.0).astype(np.float32)
    n_lists = Q * kp // g

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    probes = torch.arange(n_lists, dtype=torch.int32, device=device).reshape(Q, kp // g)
    lists = (put(g_codes.reshape(n_lists, g, g_codes.shape[-1])), put(g_inv.reshape(n_lists, g)),
             put(cand.reshape(n_lists, g)), probes)
    if t0 is not None:
        spans.record_here("rerank.host", t0, time.perf_counter_ns())
    return lists


def sdc_rerank_gathered(q_codes, fine_codes: np.ndarray, fine_inv_norm: np.ndarray, cand_ids,
                        *, n_levels: int, k: int, packed: bool = False,
                        group: int = RERANK_GROUP, backend: str = "auto"):
    """Cold-tier rerank: host-gather the survivor rows, score them on
    ``q_codes``' device.

    For a numpy fine tier (``np.memmap`` included), the survivors' ids
    come to the host (a device-to-host copy per call), their rows are
    gathered there, k' per query, never the corpus, and the block is
    uploaded as [Q * k' / group, group] candidate lists with an identity
    probe table and no mask (``host_gathered_lists``): an empty slot
    carries inverse norm 0 and id -1, which the gather excludes.
    ``group`` (the rerank axis of a ``BlockPlan``; default 1) is the
    number of rows per list. Scores are per (query, candidate) and the
    gather's ties go by slot, which is the sorted candidate order in
    every layout, so every group size gives the bits of ``sdc_rerank``.
    """
    q = torch.as_tensor(q_codes)
    lists = host_gathered_lists(fine_codes, fine_inv_norm, cand_ids, group=group,
                                device=q.device)
    fn = sdc_gather_topk_torch if resolve_backend(backend, q.device) == "torch" else sdc_gather_topk
    return fn(q, *lists, n_levels=n_levels, k=k, packed=packed)


def sdc_rerank_backend(q_codes, fine_codes, fine_inv_norm, cand_ids, *, n_levels: int, k: int,
                       backend: str = "auto", packed: bool = False,
                       block_plan: BlockPlan | None = None):
    """Dispatch a fine rerank.

    A numpy fine tier (the cold, possibly memory-mapped layout) always
    takes the host gather (``sdc_rerank_gathered``), whatever the
    backend: moving the whole corpus to the device would defeat the
    tiering; ``block_plan`` (kind "rerank") sets its group size. A
    tensor tier goes to ``sdc_rerank`` ("cuda", or "auto" on CUDA
    tensors) or ``sdc_rerank_torch`` ("torch", or "auto" on CPU
    tensors); there the plan is inert. Every route gives the same bits.
    """
    if isinstance(fine_codes, np.ndarray):
        group = (block_plan.block_n if block_plan is not None and block_plan.kind == "rerank"
                 else RERANK_GROUP)
        return sdc_rerank_gathered(q_codes, fine_codes, fine_inv_norm, cand_ids,
                                   n_levels=n_levels, k=k, packed=packed, group=group,
                                   backend=backend)
    fn = sdc_rerank_torch if resolve_backend(backend, q_codes.device) == "torch" else sdc_rerank
    return fn(q_codes, fine_codes, fine_inv_norm, cand_ids, n_levels=n_levels, k=k,
              packed=packed)
