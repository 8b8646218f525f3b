"""Public name of the DLRM dot interaction (ports
``repro/kernels/dot_interact/ops.py::dot_interaction``), differentiable.

The reference's wrapper pads B to its blocks and has ``interpret`` and
``use_kernel=False`` options for where Pallas cannot run. The port's
kernel masks the ragged edge of B itself and a CPU tensor takes its plain
version, so none of those options carries over. ``dot_interaction`` is
``kernel.dot_interact`` inside a ``torch.autograd.Function``: its forward
is the CUDA kernel on a CUDA tensor (``dot_interact.launches`` counts it)
and ``dot_interact_torch`` on a CPU tensor, with no other route. A caller
that wants the Gram-matrix form passes ``ref.dot_interact_ref`` as
``DLRM.forward(interact_fn=...)``.

The backward is ``dot_interact_backward``, plain torch: the reference has
no backward kernel either (JAX differentiates ``dot_interact_ref``'s
``dot_general`` outside any Pallas kernel). The [B, P] gradient goes into
the strict lower triangle of a [B, F, F] matrix S, and the input's
gradient is (S + S^T) E, one ``torch.bmm``; on DTensors it runs on each
rank's examples (``parallel/spmd.py``'s sharded steps).
"""

from __future__ import annotations

import torch

from repro_torch.device import full_fp32_matmul, is_dtensor
from repro_torch.kernels.dot_interact.kernel import dot_interact
from repro_torch.kernels.dot_interact.ref import tril_indices


def dot_interact_backward(emb: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of ``dot_interact`` at ``emb`` [B, F, D] for an output
    gradient ``grad`` [B, F(F-1)/2]: (S + S^T) emb, S the triangle of ``grad``."""
    full_fp32_matmul()
    B, F, _ = emb.shape
    rows, cols = tril_indices(F, emb.device)
    s = torch.zeros((B, F, F), dtype=grad.dtype, device=grad.device)
    s[:, rows, cols] = grad
    return torch.bmm(s + s.transpose(1, 2), emb)


class DotInteract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return dot_interact(emb)

    @staticmethod
    def backward(ctx, grad):
        (emb,) = ctx.saved_tensors
        if is_dtensor(emb):
            return _sharded_backward(emb, grad)
        return dot_interact_backward(emb, grad.contiguous())


def _sharded_backward(emb, grad):
    """``dot_interact_backward`` of DTensors (a sharded step): each example's
    gradient is its own, so it runs on each rank's examples, the batch split
    as ``emb``'s is (any other split of ``emb`` gathered first)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    places = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in emb.placements)
    return local_map(lambda e, g: dot_interact_backward(e, g.contiguous()),
                     out_placements=(places,), in_placements=(places, places),
                     device_mesh=emb.device_mesh, redistribute_inputs=True)(emb, grad)


def dot_interaction(emb: torch.Tensor) -> torch.Tensor:
    """[B, F, D] f32 -> [B, F*(F-1)//2] f32 (``kernel.dot_interact``), differentiable."""
    return DotInteract.apply(emb)


__all__ = ["dot_interaction", "dot_interact_backward", "DotInteract"]
