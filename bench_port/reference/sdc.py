"""Symmetric Distance Calculation in plain PyTorch.

A code c at L levels stands for the grid value a*c + beta with
a = 2^(2-L) and beta = -(2 - 2^(1-L)). The score of a document is the
inner product of the query's and the document's values over the
document's norm:

    <v(q), v(d)> / |v(d)| = (a^2 (c_q . c_d) + a*beta (sum c_q + sum c_d) + D beta^2) / |v(d)|

The code product is exact (float32 products of integers below 2^24, TF32
off), and the float steps run in the order written above. A search ranks
by score and breaks ties toward the lower document id; ``order_keys``
makes that one int64 key a (query, document) pair.
"""

from __future__ import annotations

import torch

from bench_port.reference.binarizer import no_tf32

_LOW32 = 0xFFFFFFFF


def affine(n_levels: int):
    u = n_levels - 1
    return 2.0 ** (1 - u), -(2.0 - 2.0 ** (-u))


def coarse(codes: torch.Tensor, n_levels: int, coarse_levels: int) -> torch.Tensor:
    """The first ``coarse_levels`` levels of each code (its high bits)."""
    return (codes.to(torch.int32) >> (n_levels - coarse_levels)).to(torch.int8)


def inv_norms(codes: torch.Tensor, n_levels: int) -> torch.Tensor:
    """1 / |v(d)| of documents' codes [N, D], from the exact sum of squares in
    float64, rounded once to float32."""
    a, beta = affine(n_levels)
    v = codes.to(torch.float64) * a + beta
    return (1.0 / torch.sqrt(torch.sum(v * v, dim=-1))).to(torch.float32)


def scores(q_codes: torch.Tensor, d_codes: torch.Tensor, d_inv: torch.Tensor,
           n_levels: int) -> torch.Tensor:
    """SDC scores [Q, N] of query codes [Q, D] against document codes [N, D]."""
    a, beta = affine(n_levels)
    with no_tf32():
        dot = torch.matmul(q_codes.to(torch.float32), d_codes.to(torch.float32).t())
    sums = (q_codes.to(torch.int32).sum(-1)[:, None]
            + d_codes.to(torch.int32).sum(-1)[None, :]).to(torch.float32)
    s = (a * a) * dot + (a * beta) * sums
    s = s + q_codes.shape[1] * (beta * beta)
    return s * d_inv[None, :]


def order_keys(s: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (score descending, id ascending): the float's bits
    made monotone in the high word, the complement of the id in the low."""
    bits = s.contiguous().view(torch.int32)
    mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    return (mono << 32) | (_LOW32 - ids.to(torch.int64))


def decode_keys(keys: torch.Tensor):
    """(scores float32, ids int64) of ``order_keys``' keys."""
    mono = (keys >> 32).to(torch.int32)
    bits = torch.where(mono >= 0, mono, mono ^ 0x7FFFFFFF)
    return bits.view(torch.float32), _LOW32 - (keys & _LOW32)
