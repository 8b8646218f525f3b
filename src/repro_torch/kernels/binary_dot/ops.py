"""Top-k search with the xor+popcount distance (ports
``repro/kernels/binary_dot/ops.py::binary_dot_search``).

The score matrix comes from ``kernel.binary_dot`` (the CUDA kernel for
CUDA tensors, the plain version for CPU tensors) and the top-k from the
SDC path's ``select_topk``: a stable sort, so ties go to the lower id
as in ``jax.lax.top_k``. Bitwise scores are dyadic, so ties are common.

One departure from the reference: it pads N to its tile and, when k
exceeds N, returns the padded columns' indices (>= N) beside -1e30. Here
nothing is padded and such slots come back as (-1e30, -1), as in
``sdc_search``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.binary_dot.kernel import binary_dot
from repro_torch.kernels.binary_dot.ref import binary_dot_ref
from repro_torch.kernels.sdc.ops import select_topk


def binary_dot_search(q_packed: torch.Tensor, d_packed: torch.Tensor, *, m: int, k: int):
    """Top-k exhaustive search: (scores [Q, k] f32, ids [Q, k] int32)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return select_topk(binary_dot(q_packed, d_packed, m=m), k)


def binary_dot_search_torch(q_packed: torch.Tensor, d_packed: torch.Tensor, *, m: int, k: int):
    """The plain version of ``binary_dot_search``, on any device (same bits)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return select_topk(binary_dot_ref(q_packed, d_packed, m), k)
