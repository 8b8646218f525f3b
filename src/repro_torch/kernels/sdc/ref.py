"""Plain PyTorch oracles for Symmetric Distance Calculation (ports
``repro/kernels/sdc/ref.py``: ``doc_inv_norms``, ``sdc_ref``,
``sdc_ref_affine``).

``code_dot`` is the exact integer code product used by every plain
scoring path of the port. ``torch.matmul`` has no int32 kernel on CUDA,
and ``int8 @ int8`` on the CPU returns int8 and wraps, so the codes are
multiplied as float32 with TF32 off and converted back: every partial
sum is an integer below 2^24 (at most 128 * 128 * D < 2^24 for
D < 1024), so the float32 product is exact on either device.
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize_lib import codes_to_values, sdc_affine_epilogue
from repro_torch.device import full_fp32_matmul

MAX_EXACT_DIM = 1023


def code_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b.T`` for int8/uint8 code matrices [Q, D] x [N, D]."""
    D = a.shape[-1]
    if D > MAX_EXACT_DIM:
        raise ValueError(f"code dim {D} too wide for an exact float32 code product")
    full_fp32_matmul()
    return torch.matmul(a.to(torch.float32), b.to(torch.float32).t()).to(torch.int32)


def doc_inv_norms(d_codes: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Reciprocal L2 norms of document grid values.

    The sum of squares is exact in float32. Its reciprocal square root is
    taken as a correctly rounded square root and a correctly rounded
    division, so the card and the CPU give the same bits (``torch.rsqrt``
    on CUDA is an approximation within two ulp). The square root is taken
    in float64 and rounded to float32, which is the correctly rounded
    float32 root: PyTorch's float32 ``sqrt`` on the CPU is not (one ulp
    off on about 0.6% of inputs in torch 2.13). The result may differ
    from the reference's ``jax.lax.rsqrt`` by one ulp.
    """
    v = codes_to_values(d_codes, n_levels)
    s = torch.sum(v * v, dim=-1) + 1e-12
    return torch.sqrt(s.to(torch.float64)).to(torch.float32).reciprocal()


def sdc_ref(q_codes, d_codes, n_levels: int, d_inv_norm=None) -> torch.Tensor:
    """Exact SDC scores [Q, N]: <v(q), v(d)> / ||v(d)||."""
    full_fp32_matmul()
    vq = codes_to_values(q_codes, n_levels)
    vd = codes_to_values(d_codes, n_levels)
    if d_inv_norm is None:
        d_inv_norm = doc_inv_norms(d_codes, n_levels)
    return (vq @ vd.t()) * d_inv_norm[None, :]


def sdc_ref_affine(q_codes, d_codes, n_levels: int, d_inv_norm=None) -> torch.Tensor:
    """Affine-identity formulation: integer code product + rank-1 terms."""
    D = q_codes.shape[-1]
    dot = code_dot(q_codes, d_codes)
    sq = q_codes.to(torch.int32).sum(-1, keepdim=True)
    sd = d_codes.to(torch.int32).sum(-1, keepdim=True).t()
    if d_inv_norm is None:
        d_inv_norm = doc_inv_norms(d_codes, n_levels)
    return sdc_affine_epilogue(
        dot, sq + sd, dim=D, n_levels=n_levels, inv_norm=d_inv_norm[None, :]
    )
