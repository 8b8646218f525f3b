"""Flat (exhaustive) indexes (ports ``repro/index/flat.py``).

  * FlatFloat — full-precision cosine (the paper's "float / flat" row), a
                plain product outside any kernel, as in the reference.
  * FlatSDC   — recurrent binary codes scored by the SDC kernel.
  * BiGranularFlat — a coarse FlatSDC over level-prefix codes (hot tier)
                whose top-k' survivors are reranked on the full-level codes
                (cold tier) by the gather kernel; ``flat_search_from_snapshot``
                builds it (or a FlatSDC) from a corpus snapshot.
  * FlatBitwise — the paper's bitwise baseline: the codes' bit planes
                scored by xor + popcount (the ``binary_dot`` kernel).

They live on the device they are built on: ``device="cuda"`` by default,
raising when there is no card; pass ``device="cpu"`` for the plain
scoring path on the CPU. A bi-granular index built from numpy codes keeps
its fine tier in host memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.binarize_lib import coarse_codes, pack_code_planes, pack_codes_nibbles
from repro_torch.device import full_fp32_matmul, resolve_device
from repro_torch.index._snapshot import resolve_rerank_args, resolve_snapshot_args, split_effort
from repro_torch.kernels.binary_dot.ops import binary_dot_search
from repro_torch.kernels.sdc import ref as sdc_ref
from repro_torch.kernels.sdc.defaults import BLOCK_N, FLAT_BLOCK_Q, BlockPlan, plan_for
from repro_torch.kernels.sdc.ops import sdc_search_backend
from repro_torch.kernels.sdc.rerank import fine_inv_norms, sdc_rerank_backend
from repro_torch.kernels.sdc.sdc import merge_running_topk

_CHUNK = 1 << 20


def _l2norm_rows(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + 1e-12)


@dataclasses.dataclass
class FlatFloat:
    emb: torch.Tensor  # [N, D] float, L2-normalised at build

    @staticmethod
    def build(emb, device="cuda", chunk: int = _CHUNK) -> "FlatFloat":
        """Normalise ``emb`` [N, D] row by row into a new tensor on ``device``."""
        dev = resolve_device(device)
        emb = torch.as_tensor(emb)
        out = torch.empty(emb.shape, dtype=torch.float32, device=dev)
        for s in range(0, emb.shape[0], chunk):
            out[s:s + chunk] = _l2norm_rows(emb[s:s + chunk].to(dev, torch.float32))
        return FlatFloat(emb=out)

    def search(self, q, k: int, chunk: int = _CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cosine top-k: (scores [Q, k], ids [Q, k]), ties toward the lower id."""
        full_fp32_matmul()
        q = _l2norm_rows(torch.as_tensor(q, dtype=torch.float32, device=self.emb.device))
        run_v = torch.empty((q.shape[0], 0), device=q.device)
        run_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
        for s in range(0, self.emb.shape[0], chunk):
            scores = q @ self.emb[s:s + chunk].t()
            ids = torch.arange(s, s + scores.shape[1], device=q.device)
            run_v, run_i = merge_running_topk(run_v, run_i, scores,
                                              ids.expand(q.shape[0], -1), k)
        return run_v, run_i

    def nbytes(self) -> int:
        return self.emb.numel() * self.emb.element_size()


@dataclasses.dataclass
class FlatSDC:
    codes: torch.Tensor  # [N, m] int8; nibble-packed uint8 [N, m//2] if packed
    inv_norm: torch.Tensor  # [N] f32
    n_levels: int
    packed: bool = False  # int4 code streaming (2 dims/byte)
    backend: str = "auto"  # "auto" | "cuda" | "torch" (kernels/sdc/ops.py)

    @staticmethod
    def build(codes, n_levels: int, packed: bool = False, backend: str = "auto",
              device="cuda") -> "FlatSDC":
        """Index integer codes [N, m] on ``device``.

        The inverse norms come from the port's ``doc_inv_norms`` (within
        one ulp of the reference's); codes are nibble-packed when
        ``packed`` (n_levels <= 4).
        """
        dev = resolve_device(device)
        codes = torch.as_tensor(codes).to(dev, torch.int8)
        inv = sdc_ref.doc_inv_norms(codes, n_levels)
        if packed:
            if n_levels > 4:
                raise ValueError(f"packed codes need n_levels <= 4, got {n_levels}")
            codes = pack_codes_nibbles(codes)
        return FlatSDC(codes=codes.contiguous(), inv_norm=inv, n_levels=n_levels,
                       packed=packed, backend=backend)

    @property
    def code_dim(self) -> int:
        m = self.codes.shape[1]
        return m * 2 if self.packed else m

    def search(self, q_codes, k: int, block_n: int = BLOCK_N,
               block_q: int = FLAT_BLOCK_Q, block_plan: BlockPlan | None = None):
        """Top-k SDC search of query codes [Q, m] (moved to the index's device).

        ``block_plan`` (a scan ``BlockPlan``, e.g. from ``launch/autotune``)
        is the card kernel's launch geometry; inert on the CPU. It changes
        no score or id."""
        q = torch.as_tensor(q_codes).to(self.codes.device, torch.int8).contiguous()
        return sdc_search_backend(
            q, self.codes, self.inv_norm, n_levels=self.n_levels, k=k,
            backend=self.backend, block_q=block_q, block_n=block_n,
            packed=self.packed, block_plan=block_plan,
        )

    def nbytes(self) -> int:
        # 4-bit codes pack two dims per byte on disk; +4B quantised norm.
        packed_codes = (self.code_dim * self.n_levels + 7) // 8
        return self.codes.shape[0] * (packed_codes + 4)


def device_codes(codes, device) -> torch.Tensor:
    """Codes [N, m], numpy (a read-only ``np.memmap`` too) or a tensor, as
    a contiguous int8 tensor on ``device``."""
    if isinstance(codes, np.ndarray) and not codes.flags.writeable:
        codes = np.array(codes)  # torch wraps no read-only array
    return torch.as_tensor(codes).to(device, torch.int8).contiguous()


@dataclasses.dataclass
class BiGranularFlat:
    """Two-tier exhaustive index: hot coarse scan, cold fine rerank.

    The coarse tier is a plain ``FlatSDC`` over the level-prefix codes
    (the first ``coarse_levels`` residual levels, a right shift;
    nibble-packed when ``coarse_levels <= 4`` and ``packed``). The fine
    tier keeps the full-level codes: a numpy array (``np.memmap``
    included) stays on the host and only the survivors' rows are read
    from it; a tensor moves to the index's device.

    On the card the coarse tier stores one code per byte (or per nibble,
    packed) at any ``coarse_levels``, so its scan reads as many bytes as
    a full-level scan; the serialized size (``coarse_nbytes``) counts
    ``coarse_levels`` bits a dim. The rerank is bit-identical to a
    full-level flat scan restricted to the survivors, so ``k_coarse >=
    N`` gives exactly ``FlatSDC.search`` at full levels.
    """

    coarse: FlatSDC
    fine_codes: Any  # [N, D] int8 full-level codes: a tensor, or numpy on the host
    fine_inv_norm: Any  # [N] f32, numpy beside numpy codes
    n_levels: int
    coarse_levels: int
    k_coarse: int
    backend: str = "auto"

    @staticmethod
    def build(codes, n_levels: int, *, coarse_levels: int, k_coarse: int,
              packed: bool = False, backend: str = "auto", device="cuda") -> "BiGranularFlat":
        """Index integer codes [N, m]: the coarse tier on ``device``, the
        fine tier there too unless ``codes`` is numpy."""
        dev = resolve_device(device)
        full = device_codes(codes, dev)
        coarse = FlatSDC.build(coarse_codes(full, n_levels, coarse_levels), coarse_levels,
                               packed=packed and coarse_levels <= 4, backend=backend,
                               device=dev)
        fine = codes if isinstance(codes, np.ndarray) else full
        del full  # a host tier's device copy was only the coarse tier's source
        return BiGranularFlat(
            coarse=coarse, fine_codes=fine, fine_inv_norm=fine_inv_norms(fine, n_levels,
                                                                         device=dev),
            n_levels=n_levels, coarse_levels=coarse_levels, k_coarse=k_coarse,
            backend=backend,
        )

    def search(self, q_codes, k: int, block_n: int = BLOCK_N, k_coarse: int | None = None,
               scan_plan: BlockPlan | None = None, rerank_plan: BlockPlan | None = None):
        """Top-k of query codes [Q, m]: the coarse scan's top-k' ids, reranked."""
        kc = self.k_coarse if k_coarse is None else k_coarse
        kc = min(kc, self.fine_codes.shape[0])
        q = torch.as_tensor(q_codes).to(self.coarse.codes.device, torch.int8).contiguous()
        qc = coarse_codes(q, self.n_levels, self.coarse_levels)
        _, cand = self.coarse.search(qc, kc, block_n=block_n, block_plan=scan_plan)
        return sdc_rerank_backend(q, self.fine_codes, self.fine_inv_norm, cand,
                                  n_levels=self.n_levels, k=k, backend=self.backend,
                                  block_plan=rerank_plan)

    def coarse_nbytes(self) -> int:
        return self.coarse.nbytes()

    def nbytes(self) -> int:
        fine = self.fine_codes.shape[0] * (
            (self.fine_codes.shape[1] * self.n_levels + 7) // 8 + 4
        )
        return self.coarse.nbytes() + fine


def flat_search_from_snapshot(codes, n_levels: int = None, *, k: int, packed: bool = False,
                              backend: str = "auto", block_n: int = BLOCK_N,
                              rerank: dict | None = None, effort=None, block_plan=None,
                              device="cuda"):
    """Rebuild-from-snapshot entry point: a serving closure ``codes -> (scores, ids)``.

    Builds a fresh exhaustive index on ``device`` from a snapshot's
    unpacked codes (anything with ``.codes`` and ``.n_levels``, or raw
    codes and ``n_levels``). Deterministic: the same snapshot and
    parameters give the same index, bit for bit.

    ``rerank={"coarse_levels": c, "k_coarse": k'}`` switches the closure
    to bi-granular mode (``BiGranularFlat``) and sets ``fn.reranked =
    True``; numpy snapshot codes keep the fine tier on the host. ``effort``
    (anything with an int ``level``, 0 = full, e.g.
    ``launch.proxy.EffortKnob``) is read per call and halves ``k_coarse``
    per level, floored at k (``split_effort``); level 0 is bit-identical
    to ``effort=None``. A flat index has no other cost knob, so ``effort``
    without ``rerank`` is ignored. ``block_plan`` (a ``BlockPlan`` or a
    ``{kind: plan}`` mapping) reaches the scan and, in bi-granular mode,
    the rerank: on the card a scan plan is ``sdc_topk``'s launch geometry
    (the coarse scan's in bi-granular mode), a rerank plan the host
    gather's group. Plans never change scores.
    """
    codes, n_levels = resolve_snapshot_args(codes, n_levels)
    rr = resolve_rerank_args(rerank, n_levels)
    scan_plan = plan_for(block_plan, "scan")
    rerank_plan = plan_for(block_plan, "rerank")
    if rr is None:
        index = FlatSDC.build(device_codes(codes, resolve_device(device)), n_levels,
                              packed=packed, backend=backend, device=device)
        return lambda q: index.search(q, k, block_n=block_n, block_plan=scan_plan)

    c_levels, k_coarse = rr
    bigr = BiGranularFlat.build(codes, n_levels, coarse_levels=c_levels, k_coarse=k_coarse,
                                packed=packed, backend=backend, device=device)

    def fn(q):
        kc = None if effort is None else split_effort(effort.level, k=k, k_coarse=k_coarse)[0]
        return bigr.search(q, k, block_n=block_n, k_coarse=kc, scan_plan=scan_plan,
                           rerank_plan=rerank_plan)

    if effort is not None:
        fn.effort = effort
    fn.reranked = True
    return fn


@dataclasses.dataclass
class FlatBitwise:
    packed: torch.Tensor  # [N, n_levels, m/32] int32 words (the reference's uint32 bits)
    m: int
    n_levels: int

    @staticmethod
    def build(codes, n_levels: int, device="cuda") -> "FlatBitwise":
        """Pack integer codes [N, m] into bit planes on ``device``."""
        dev = resolve_device(device)
        codes = torch.as_tensor(codes).to(dev, torch.int8)
        return FlatBitwise(packed=pack_code_planes(codes, n_levels), m=codes.shape[1],
                           n_levels=n_levels)

    def search(self, q_codes, k: int):
        """Top-k of query codes [Q, m] (moved to the index's device) by xor + popcount."""
        q = torch.as_tensor(q_codes).to(self.packed.device, torch.int8)
        return binary_dot_search(pack_code_planes(q, self.n_levels), self.packed, m=self.m,
                                 k=k)

    def nbytes(self) -> int:
        return self.packed.numel() * 4
