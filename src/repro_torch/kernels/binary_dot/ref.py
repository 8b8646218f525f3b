"""Oracle and plain version of the bitwise recurrent-binary dot (paper
Eq. 11-12; ports ``repro/kernels/binary_dot/ref.py``).

Unpack the +-1 bit planes and evaluate

  <b_u^q, b_u^d> = sum_{s,t} 2^{-(s+t)} (bits_s^q . bits_t^d)

as the product of the level-weighted values v = sum_t 2^-t bits_t.

Exactness, which the tests and the card check rely on: every value is a
multiple of 2^-(n-1) with |v| <= 2 - 2^-(n-1), so every product term and
every partial sum of a score is a multiple of 2^-(2n-2) of magnitude at
most m (2 - 2^-(n-1))^2, that is at most m (2^n - 1)^2 of those units.
At m = 128 and n = 4 that is 28,800 < 2^15, far inside float32's 2^24:
the float32 product (TF32 off) is exact in any summation order, on the
CPU and on the card, and so equals the kernel's integer popcount sums.
The bound holds while m (2^n - 1)^2 <= 2^24 (m = 256 up to n = 8).
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize_lib import unpack_bitplanes
from repro_torch.device import full_fp32_matmul

_CHUNK = 1 << 18


def level_values(packed: torch.Tensor, m: int) -> torch.Tensor:
    """Packed planes [R, n, W] -> level-weighted values [R, m] f32 (exact)."""
    bits = unpack_bitplanes(packed, m)  # [R, n, m] in {-1, +1}
    w = 2.0 ** -torch.arange(bits.shape[-2], dtype=torch.float32, device=bits.device)
    return torch.einsum("rnm,n->rm", bits, w)


def binary_dot_ref(q_packed: torch.Tensor, d_packed: torch.Tensor, m: int,
                   chunk: int = _CHUNK) -> torch.Tensor:
    """Scores [Q, N] f32 from packed bit planes, on any device.

    Args:
      q_packed: [Q, n_levels, W] int32 words (the reference's uint32 bits),
        W = m // 32.
      d_packed: [N, n_levels, W] int32 words.
      m: code dimension.
      chunk: documents unpacked at a time (memory only; the result is
        exact, so it does not depend on ``chunk``).
    """
    full_fp32_matmul()
    vq = level_values(q_packed, m)
    N = d_packed.shape[0]
    out = torch.empty((q_packed.shape[0], N), dtype=torch.float32, device=q_packed.device)
    for s in range(0, N, chunk):
        out[:, s:s + chunk] = vq @ level_values(d_packed[s:s + chunk], m).t()
    return out
