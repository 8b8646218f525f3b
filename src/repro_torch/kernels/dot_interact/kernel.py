"""Fused DLRM dot interaction (ports
``repro/kernels/dot_interact/kernel.py::dot_interact``).

``dot_interact`` dispatches on the device of its input: a CUDA tensor
goes to the hand-written Hopper kernel in ``csrc/dot_interact.cu``, a
CPU tensor to ``dot_interact_torch``, the plain PyTorch version, which
gives the same bits. There is no other route: on a CUDA tensor the
kernel launches or the call raises. The kernel masks the ragged edge of
B itself, so nothing is padded (the reference pads B to its block).

Its bound on the card is bytes: the [B, F, D] input read once and the
[B, F(F-1)/2] output written once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dot_interact.ref import dot_interact_torch

_SMEM_MAX = 227 * 1024  # shared memory a block can use on Hopper
_MAX_THREADS = 1024


def dot_interact(emb: torch.Tensor) -> torch.Tensor:
    """[B, F, D] f32 -> [B, F*(F-1)//2] f32, pairs in ``np.tril_indices(F, -1)`` order.

    CUDA tensors run the kernel (``dot_interact.launches`` counts its
    launches), CPU tensors the plain version.
    """
    if not isinstance(emb, torch.Tensor) or emb.dim() != 3 or emb.dtype != torch.float32:
        raise ValueError("emb must be a float32 tensor [B, F, D]")
    if emb.shape[1] < 2 or emb.shape[2] < 1:
        raise ValueError(f"emb needs F >= 2 features of D >= 1, got {tuple(emb.shape)}")
    if emb.device.type == "cpu":
        return dot_interact_torch(emb)
    if emb.device.type != "cuda":
        raise ValueError(f"no dot_interact kernel for device {emb.device}")
    return _launch(emb)


dot_interact.launches = 0


def _launch(emb: torch.Tensor) -> torch.Tensor:
    B, F, D = emb.shape
    P = F * (F - 1) // 2
    if B >= 2**31:
        raise ValueError(f"batch of {B} examples exceeds the kernel's int32 count")
    emb = emb.contiguous()
    out = torch.empty((B, P), dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    lib = _lib()
    smem = lib.dot_interact_smem(F, D)
    if smem > _SMEM_MAX:
        raise ValueError(f"F={F}, D={D} needs {smem} bytes of shared memory per block, "
                         f"more than {_SMEM_MAX}")
    threads = min(_MAX_THREADS, -(-P // 32) * 32)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.dot_interact_launch(emb.data_ptr(), out.data_ptr(), B, F, D, threads, stream)
    if err != 0:
        msg = lib.dot_interact_error_string(err).decode()
        raise RuntimeError(f"dot_interact launch failed: CUDA error {err} ({msg})")
    dot_interact.launches += 1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built on first use), its C functions declared."""
    lib = _build.load(_build.DOT_INTERACT)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dot_interact_launch.argtypes = [P, P, I, I, I, I, P]
    lib.dot_interact_launch.restype = I
    lib.dot_interact_smem.argtypes = [I, I]
    lib.dot_interact_smem.restype = ctypes.c_size_t
    lib.dot_interact_error_string.argtypes = [I]
    lib.dot_interact_error_string.restype = ctypes.c_char_p
    return lib
