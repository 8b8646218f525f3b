"""Public wrappers around the SDC kernels: top-k search, gather search
and backend selection (ports ``repro/kernels/sdc/ops.py``).

Backends, the same for the flat scan and the gather of probed lists:

  * "cuda"  — the hand-written Hopper kernels (``sdc.sdc_topk``,
              ``sdc.sdc_scores``, ``gather.sdc_gather_topk``); CUDA
              tensors only.
  * "torch" — the plain PyTorch twins (``sdc_search_torch``,
              ``gather.sdc_gather_topk_torch``), the counterpart of the
              reference's "xla"; any device.
  * "auto"  — follows the device of the tensors: "cuda" for CUDA
              tensors, "torch" for CPU tensors. It never switches a CUDA
              tensor to the plain version.

The reference pads the corpus to a multiple of its block and masks the
padding through a zero inverse norm. The CUDA kernel masks the ragged
edge of N itself, so nothing is padded here: at ten million documents
that pad would be a 1.3 GB copy per call.
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize_lib import SDC_NEG_INF
from repro_torch.kernels.sdc.defaults import BLOCK_N, BLOCK_Q, BlockPlan
from repro_torch.kernels.sdc.gather import sdc_gather_topk, sdc_gather_topk_torch
from repro_torch.kernels.sdc.sdc import (  # noqa: F401  (select_topk: public here too)
    sdc_scores,
    sdc_scores_torch,
    sdc_topk,
    sdc_topk_torch,
    select_topk,
    unfused_topk,
)

NEG_INF = SDC_NEG_INF
BACKENDS = ("auto", "cuda", "torch")


def resolve_backend(backend: str = "auto", device=None) -> str:
    """Resolve the backend flag for tensors on ``device`` to "cuda" or "torch"."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown SDC backend {backend!r}; want one of {BACKENDS}")
    dev = torch.device(device) if device is not None else None
    if backend == "auto":
        if dev is None:
            raise ValueError("backend 'auto' needs the device of the tensors")
        return "cuda" if dev.type == "cuda" else "torch"
    if backend == "cuda" and dev is not None and dev.type != "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {dev}")
    return backend


def sdc_search(
    q_codes: torch.Tensor,
    d_codes: torch.Tensor,
    d_inv_norm: torch.Tensor,
    *,
    n_levels: int,
    k: int,
    block_q: int = BLOCK_Q,
    block_n: int = BLOCK_N,
    packed: bool = False,
    fused: bool = True,
):
    """Top-k SDC search of queries against a code corpus.

    Args:
      q_codes: [Q, D] int8 recurrent-binary codes of queries.
      d_codes: [N, D] int8 codes of documents, or nibble-packed uint8
        [N, D//2] when ``packed=True``.
      d_inv_norm: [N] f32 reciprocal doc-value norms (0 => excluded).
      block_q, block_n: the reference's tile shapes; the kernels size their
        own grids, so they change nothing here (checked, then unused).
      fused: the fused scan + top-k kernel; False writes the [Q, N] score
        matrix (``sdc_scores``) and selects from it, a chunk of queries at
        a time (``sdc.unfused_topk``).

    Returns:
      (scores [Q, k], indices [Q, k]); slots with no valid candidate
      (excluded docs, k > N) come back as (SDC_NEG_INF, -1). ``k > N``
      is legal. The kernels on CUDA tensors, the plain versions on CPU
      tensors.
    """
    if block_q < 1 or block_n < 1:
        raise ValueError(f"blocks must be >= 1, got ({block_q}, {block_n})")
    return _search(sdc_topk, sdc_scores, q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k,
                   packed=packed, fused=fused)


def _search(topk_fn, scores_fn, q_codes, d_codes, d_inv_norm, *, n_levels, k, packed, fused):
    """The fused top-k ``topk_fn``, or with ``fused=False`` the score matrix
    of ``scores_fn`` and ``select_topk`` of it (``unfused_topk``)."""
    if fused:
        return topk_fn(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k, packed=packed)
    return unfused_topk(scores_fn, q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k,
                        packed=packed)


def sdc_search_torch(q_codes, d_codes, d_inv_norm, *, n_levels: int, k: int,
                     packed: bool = False):
    """Plain PyTorch top-k SDC search (the "torch" backend), on any device.

    Same contract as ``sdc_search``; the twin of the reference's
    ``sdc_search_xla``: exact integer code products, the shared
    epilogue, and a stable sort, so scores and ids are bit-identical to
    the kernel.
    """
    return sdc_topk_torch(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k,
                          packed=packed)


def sdc_search_backend(
    q_codes, d_codes, d_inv_norm, *, n_levels, k, backend="auto",
    block_q=BLOCK_Q, block_n=BLOCK_N, packed=False,
    block_plan: BlockPlan | None = None, fused: bool = True,
):
    """Dispatch a top-k SDC search to the resolved backend.

    ``block_plan`` overrides ``block_q``/``block_n`` when given. Blocks
    never change scores or ids, and neither does ``fused``.
    """
    backend = resolve_backend(backend, q_codes.device)
    if block_plan is not None:
        block_q, block_n = block_plan.block_q, block_plan.block_n
    if backend == "torch":
        return _search(sdc_topk_torch, sdc_scores_torch, q_codes, d_codes, d_inv_norm,
                       n_levels=n_levels, k=k, packed=packed, fused=fused)
    return sdc_search(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k,
                      block_q=block_q, block_n=block_n, packed=packed, fused=fused)


def sdc_gather_backend(q_codes, lists_codes, lists_inv_norm, lists_ids, probes, *,
                       n_levels, k, backend="auto", packed=False, cand_mask=None):
    """Dispatch a gather search of probed lists to the resolved backend.

    "cuda" runs ``gather.sdc_gather_topk`` (the kernel), "torch" its plain
    twin ``sdc_gather_topk_torch`` (the reference's
    ``sdc_gather_topk_xla``); both give the same bits.
    """
    backend = resolve_backend(backend, q_codes.device)
    fn = sdc_gather_topk_torch if backend == "torch" else sdc_gather_topk
    return fn(q_codes, lists_codes, lists_inv_norm, lists_ids, probes, n_levels=n_levels,
              k=k, packed=packed, cand_mask=cand_mask)

