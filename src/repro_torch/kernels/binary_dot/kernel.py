"""The xor+popcount baseline's score matrix (ports
``repro/kernels/binary_dot/kernel.py::binary_dot``).

``binary_dot`` dispatches on the device of its inputs: a CUDA tensor goes
to the hand-written Hopper kernel in ``csrc/binary_dot.cu`` (``__popc``
on the CUDA cores, one document per thread, every query's planes in
shared memory), a CPU tensor to ``binary_dot_ref``, the plain PyTorch
version. There is no other route: on a CUDA tensor the kernel launches
or the call raises. The kernel masks the ragged edge of N itself, so
nothing is padded (the reference pads to its tiles).

Its bound on the card is popcounts, not bytes: n_levels^2 * W of them
per (query, document), at 16 per SM per clock.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.binary_dot.ref import binary_dot_ref

# Shapes the kernel is instantiated for: n_levels and words per plane.
KERNEL_LEVELS = (1, 2, 3, 4)
KERNEL_WORDS = (1, 2, 3, 4, 8)

_THREADS = 256  # documents per block and round, as in the source
_MAX_QUERIES_PER_BLOCK = 64


def _check_inputs(q_packed, d_packed, m: int) -> None:
    for name, t in (("q_packed", q_packed), ("d_packed", d_packed)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be an int32 tensor [rows, n_levels, m/32]")
    if m < 32 or m % 32:
        raise ValueError(f"m must be a positive multiple of 32, got {m}")
    if q_packed.shape[1:] != d_packed.shape[1:] or q_packed.shape[2] != m // 32:
        raise ValueError(
            f"planes {tuple(q_packed.shape)} and {tuple(d_packed.shape)} do not match "
            f"m={m} (want [*, n_levels, {m // 32}] on both sides)"
        )
    if q_packed.device != d_packed.device:
        raise ValueError(f"inputs on different devices: {q_packed.device}, {d_packed.device}")


def _check_rows(d: torch.Tensor) -> None:
    """The kernel reads a document's n_levels * W words as 16-byte vectors
    when that count is a multiple of 4, and word by word otherwise; only
    the vector loads need the rows 16-byte aligned."""
    if not d.is_contiguous():
        raise ValueError("d_packed must be contiguous")
    n_levels, W = d.shape[1:]
    if (n_levels * W) % 4 == 0 and d.data_ptr() % 16:
        raise ValueError(
            f"d_packed rows of {n_levels * W} words are read as 16-byte vectors; "
            "the tensor must start 16-byte aligned"
        )


def binary_dot(q_packed: torch.Tensor, d_packed: torch.Tensor, *, m: int) -> torch.Tensor:
    """Scores [Q, N] f32 = sum_{s,t} 2^-(s+t) (m - 2 popc(q_s ^ d_t)).

    ``q_packed`` [Q, n_levels, m/32] and ``d_packed`` [N, n_levels, m/32]
    int32 words (``pack_bitplanes``/``pack_code_planes``). CUDA tensors
    run the kernel (``binary_dot.launches`` counts its launches), CPU
    tensors the plain version; both are exact (``ref.py``).
    """
    _check_inputs(q_packed, d_packed, m)
    if q_packed.device.type == "cpu":
        return binary_dot_ref(q_packed, d_packed, m)
    if q_packed.device.type != "cuda":
        raise ValueError(f"no binary_dot kernel for device {q_packed.device}")
    return _launch(q_packed, d_packed, m)


binary_dot.launches = 0


def _launch(q: torch.Tensor, d: torch.Tensor, m: int) -> torch.Tensor:
    Q, n_levels, W = q.shape
    N = d.shape[0]
    if n_levels not in KERNEL_LEVELS or W not in KERNEL_WORDS:
        raise ValueError(
            f"the CUDA binary_dot kernel takes n_levels {KERNEL_LEVELS} and "
            f"m in {tuple(32 * w for w in KERNEL_WORDS)}, got n_levels={n_levels}, m={m}"
        )
    if N >= 2**31 - _THREADS:
        raise ValueError(f"corpus of {N} documents exceeds int32 ids")
    q = q.contiguous()
    _check_rows(d)
    out = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    if Q == 0 or N == 0:
        return out
    lib = _lib()
    qc = min(Q, _MAX_QUERIES_PER_BLOCK)
    with torch.cuda.device(q.device):
        per_sm = lib.binary_dot_blocks_per_sm(n_levels, W, qc)
    if per_sm <= 0:
        msg = lib.binary_dot_error_string(-per_sm).decode() if per_sm < 0 else "no block fits"
        raise RuntimeError(f"binary_dot cannot be scheduled: {msg}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_blocks = max(1, min(-(-N // _THREADS), per_sm * sms))
    scale = 2.0 ** -(2 * (n_levels - 1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.binary_dot_launch(q.data_ptr(), d.data_ptr(), out.data_ptr(), Q, N, n_levels,
                                    W, qc, n_blocks, scale, stream)
    if err != 0:
        msg = lib.binary_dot_error_string(err).decode()
        raise RuntimeError(f"binary_dot launch failed: CUDA error {err} ({msg})")
    binary_dot.launches += 1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built on first use), its C functions declared."""
    lib = _build.load(_build.BINARY_DOT)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.binary_dot_launch.argtypes = [P, P, P, I, I, I, I, I, I, F, P]
    lib.binary_dot_launch.restype = I
    lib.binary_dot_blocks_per_sm.argtypes = [I, I, I]
    lib.binary_dot_blocks_per_sm.restype = I
    lib.binary_dot_error_string.argtypes = [I]
    lib.binary_dot_error_string.restype = ctypes.c_char_p
    return lib
