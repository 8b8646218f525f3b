"""Fused DLRM dot interaction (ports
``repro/kernels/dot_interact/kernel.py::dot_interact``).

``dot_interact`` dispatches on the device of its input: a CUDA tensor
goes to the hand-written Hopper kernel in ``csrc/dot_interact.cu``, a
CPU tensor to ``dot_interact_torch``, the plain PyTorch version, which
gives the same bits. There is no other route: on a CUDA tensor the
kernel launches or the call raises. The kernel masks the ragged edge of
B itself, so nothing is padded (the reference pads B to its block).

Its bound on the card is bytes: the [B, F, D] input read once and the
[B, F(F-1)/2] output written once. The kernel's blocks are persistent:
one wave of them, several to an SM, walks the batch in stages of up to 8
examples, one block's copies in flight while the others compute
(``csrc/dot_interact.cu`` says more).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dot_interact.ref import dot_interact_torch

_SMEM_MAX = 227 * 1024  # shared memory a block can use on Hopper
# Examples a stage, in the order the wrapper tries them: the first whose
# shared memory fits a block.
_STAGE_EXAMPLES = (8, 4, 2, 1)


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
    dev = emb.device.index if emb.device.index is not None else torch.cuda.current_device()
    sms = _sm_count(dev)
    E = _stage_examples(F, D)
    while E > 1 and -(-B // E) < sms:  # a small batch: smaller stages, more blocks
        E //= 2
    grid = min(-(-B // E), _blocks_per_sm(dev, F, D, E) * sms)
    vec = int(D % 4 == 0 and emb.data_ptr() % 16 == 0)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.dot_interact_launch(emb.data_ptr(), out.data_ptr(), B, F, D, E, vec, grid,
                                      stream)
    if err != 0:
        msg = lib.dot_interact_error_string(err).decode()
        raise RuntimeError(f"dot_interact launch failed: CUDA error {err} ({msg})")
    dot_interact.launches += 1
    return out


@functools.cache
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.cache
def _blocks_per_sm(dev: int, F: int, D: int, E: int) -> int:
    """Blocks of the kernel an SM holds at this shape (the occupancy query)."""
    lib = _lib()
    with torch.cuda.device(dev):
        per_sm = lib.dot_interact_blocks_per_sm(F, D, E)
    if per_sm <= 0:
        msg = lib.dot_interact_error_string(-per_sm).decode() if per_sm < 0 else "no block fits"
        raise RuntimeError(f"dot_interact cannot be scheduled: {msg}")
    return per_sm


@functools.cache
def _stage_examples(F: int, D: int) -> int:
    """Examples a stage: the first of ``_STAGE_EXAMPLES`` whose shared memory
    fits a block; raises if none does."""
    lib = _lib()
    for E in _STAGE_EXAMPLES:
        if lib.dot_interact_smem(F, D, E) <= _SMEM_MAX:
            return E
    raise ValueError(f"F={F}, D={D} needs {lib.dot_interact_smem(F, D, 1)} bytes of shared "
                     f"memory per block, more than {_SMEM_MAX}")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built on first use), its C functions declared."""
    lib = _build.load(_build.DOT_INTERACT)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dot_interact_launch.argtypes = [P, P] + [I] * 6 + [P]
    lib.dot_interact_launch.restype = I
    lib.dot_interact_smem.argtypes = [I] * 3
    lib.dot_interact_smem.restype = ctypes.c_size_t
    lib.dot_interact_blocks_per_sm.argtypes = [I] * 3
    lib.dot_interact_blocks_per_sm.restype = I
    lib.dot_interact_error_string.argtypes = [I]
    lib.dot_interact_error_string.restype = ctypes.c_char_p
    return lib
