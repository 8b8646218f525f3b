"""Plain PyTorch oracles for Symmetric Distance Calculation (ports
``repro/kernels/sdc/ref.py``: ``doc_inv_norms``, ``sdc_ref``,
``sdc_ref_affine``, ``sdc_ref_lut``).

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


def sdc_ref_lut(q_codes, d_codes, n_levels: int, d_inv_norm=None) -> torch.Tensor:
    """The paper's CPU algorithm (int8 lookup tables over 4-bit subcodes),
    emulated: approximate SDC scores [Q, N], a plain reference with no
    kernel.

    Per query and per group of dims, a 16-entry table holds the partial
    inner products of the query's grid value(s) with every 4-bit document
    code: one dim a code at n_levels 4 (the paper's u = 4 layout), two
    adjacent dims a code at n_levels 2 (u = 2, the entries summed). The
    tables are quantised to int8 by each query's largest |entry|, and a
    score is the sum of the gathered entries, scaled back. The reference's
    op order, in float32; the sums of int8 entries are exact.
    """
    if n_levels not in (2, 4):
        raise ValueError(f"the paper's layout packs 4-bit subcodes: n_levels 2 or 4, "
                         f"got {n_levels}")
    vq = codes_to_values(q_codes, n_levels)  # [Q, D]
    centroids = codes_to_values(
        torch.arange(2**n_levels, dtype=torch.int8, device=vq.device), n_levels)
    if n_levels == 4:
        lut_f = vq[:, :, None] * centroids[None, None, :]  # [Q, D, 16]
        groups = d_codes.to(torch.int64)  # [N, D]
    else:
        Q, D = vq.shape
        if D % 2:
            raise ValueError(f"n_levels 2 pairs adjacent dims: the code dim must be even, "
                             f"got {D}")
        sub = torch.arange(16, device=vq.device)
        c_hi, c_lo = centroids[sub >> 2], centroids[sub & 3]
        vq2 = vq.reshape(Q, D // 2, 2)
        lut_f = vq2[..., 0:1] * c_hi[None, None, :] + vq2[..., 1:2] * c_lo[None, None, :]
        d2 = d_codes.to(torch.int64).reshape(d_codes.shape[0], D // 2, 2)
        groups = d2[..., 0] * 4 + d2[..., 1]  # [N, D // 2]

    scale = torch.amax(torch.abs(lut_f), dim=(1, 2), keepdim=True) + 1e-12
    lut_i8 = torch.clamp(torch.round(lut_f / scale * 127.0), -128, 127)
    # gathered[q, n, g] = lut_i8[q, g, groups[n, g]]
    G = groups.shape[1]
    gathered = torch.gather(lut_i8[:, None, :, :].expand(-1, groups.shape[0], G, 16), 3,
                            groups[None, :, :, None].expand(lut_i8.shape[0], -1, -1, 1))[..., 0]
    acc = torch.sum(gathered, dim=-1)  # [Q, N]
    scores = acc * (scale[:, :, 0] / 127.0)
    if d_inv_norm is None:
        d_inv_norm = doc_inv_norms(d_codes, n_levels)
    return scores * d_inv_norm[None, :]
