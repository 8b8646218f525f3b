"""Oracle and plain version of the DLRM dot interaction (ports
``repro/kernels/dot_interact/ref.py``; arXiv:1906.00091 §2).

Given per-example feature embeddings E in [B, F, D] (the bottom MLP's
output and the sparse fields' embeddings, stacked), the interaction is
the strictly lower triangle of the Gram matrix E E^T, flattened per
example in ``np.tril_indices(F, -1)`` order.

``dot_interact_ref`` is the reference's formulation (a batched product,
then the triangle); ``dot_interact_torch`` is the plain version the
kernel is held against: it sums over d in index order, one separately
rounded product and add at a time, as the kernel does, so the two give
the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import full_fp32_matmul


def tril_indices(num_feat: int, device=None):
    """Strictly-lower-triangle (i > j) index pairs (rows, cols), int64."""
    rows, cols = np.tril_indices(num_feat, k=-1)
    return (torch.as_tensor(rows, dtype=torch.int64, device=device),
            torch.as_tensor(cols, dtype=torch.int64, device=device))


def dot_interact_ref(emb: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, F*(F-1)//2] pairwise dots (i > j), via the Gram matrix."""
    full_fp32_matmul()
    gram = torch.einsum("bfd,bgd->bfg", emb, emb)
    rows, cols = tril_indices(emb.shape[1], emb.device)
    return gram[:, rows, cols]


def dot_interact_torch(emb: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, F*(F-1)//2], summed over d in order (the kernel's bits)."""
    B, F, D = emb.shape
    rows, cols = tril_indices(F, emb.device)
    out = torch.zeros((B, rows.numel()), dtype=emb.dtype, device=emb.device)
    for d in range(D):
        e = emb[:, :, d]
        out = out + e[:, rows] * e[:, cols]
    return out
