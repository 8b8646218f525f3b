"""Flat (exhaustive) indexes (ports ``FlatFloat`` and ``FlatSDC`` of
``repro/index/flat.py``).

  * FlatFloat — full-precision cosine (the paper's "float / flat" row), a
                plain product outside any kernel, as in the reference.
  * FlatSDC   — recurrent binary codes scored by the SDC kernel.
  * FlatBitwise — the paper's bitwise baseline: the codes' bit planes
                scored by xor + popcount (the ``binary_dot`` kernel).

Both live on the device they are built on: ``device="cuda"`` by default,
raising when there is no card; pass ``device="cpu"`` for the plain
scoring path on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.binarize_lib import pack_code_planes, pack_codes_nibbles
from repro_torch.device import full_fp32_matmul, resolve_device
from repro_torch.kernels.binary_dot.ops import binary_dot_search
from repro_torch.kernels.sdc import ref as sdc_ref
from repro_torch.kernels.sdc.defaults import BLOCK_N, FLAT_BLOCK_Q, BlockPlan
from repro_torch.kernels.sdc.ops import sdc_search_backend
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
        """Top-k SDC search of query codes [Q, m] (moved to the index's device)."""
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
