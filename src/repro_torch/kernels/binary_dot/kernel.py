"""The xor+popcount baseline's score matrix (ports
``repro/kernels/binary_dot/kernel.py::binary_dot``).

``binary_dot`` dispatches on the device of its inputs: a CUDA tensor goes
to the hand-written Hopper kernel in ``csrc/binary_dot.cu``, a CPU tensor
to ``binary_dot_ref``, the plain PyTorch version. There is no other
route: on a CUDA tensor the kernel launches or the call raises. The
kernel masks the ragged edge of N itself, so nothing is padded (the
reference pads to its tiles); its result is a view of rows padded to 32
scores, so that it writes whole 128-byte lines.

The kernel keeps the baseline's scheme, one Hamming term per plane pair
(n_levels^2 of them), but runs them on the tensor cores' binary path
(``mma.sync`` b1 ``.and.popc``), where they cost less than writing the
[Q, N] float32 scores. Its bound on the card is those bytes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.binary_dot.ref import binary_dot_ref
from repro_torch.kernels.sdc.sdc import _corpus_slices

# Shapes the kernel is instantiated for: n_levels and words per plane.
KERNEL_LEVELS = (1, 2, 3, 4)
KERNEL_WORDS = (1, 2, 3, 4, 8)

_ROWS = 128  # documents a tile (kRows): a slice of the corpus is a multiple of it
_ROW_STEP = 32  # the score matrix's rows padded to 128 bytes
_MAX_QUERIES_PER_BLOCK = 64  # kMaxQueries


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
    """The kernel copies a document's n_levels * W words as 16-byte chunks
    when that count is a multiple of 4, and word by word otherwise; only
    the 16-byte copies need the rows 16-byte aligned."""
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
    run the kernel (``binary_dot.launches`` counts its launches), whose
    result is a view of rows padded to a multiple of 32 scores; CPU
    tensors the plain version. Both are exact (``ref.py``).
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
    if N > 2**31 - _ROWS:
        raise ValueError(f"corpus of {N} documents exceeds int32 ids")
    q = q.contiguous()
    _check_rows(d)
    ldo = -(-max(N, 1) // _ROW_STEP) * _ROW_STEP
    out = torch.empty((Q, ldo), dtype=torch.float32, device=q.device)[:, :N]
    if Q == 0 or N == 0:
        return out
    lib = _lib()
    qc = min(Q, _MAX_QUERIES_PER_BLOCK)
    with torch.cuda.device(q.device):
        per_sm = lib.binary_dot_blocks_per_sm(n_levels, W, qc)
    if per_sm <= 0:
        msg = lib.binary_dot_error_string(-per_sm).decode() if per_sm < 0 else "no block fits"
        raise RuntimeError(f"binary_dot cannot be scheduled: {msg}")
    n_slices, slice_docs = _corpus_slices(N, per_sm, -(-Q // qc), q.device, _ROWS)
    scale = 2.0 ** -(2 * (n_levels - 1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.binary_dot_launch(q.data_ptr(), d.data_ptr(), out.data_ptr(), Q, N, ldo,
                                    n_levels, W, qc, n_slices, slice_docs, scale, stream)
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
    lib.binary_dot_launch.argtypes = [P, P, P] + [I] * 8 + [F, P]
    lib.binary_dot_launch.restype = I
    lib.binary_dot_blocks_per_sm.argtypes = [I, I, I]
    lib.binary_dot_blocks_per_sm.restype = I
    lib.binary_dot_error_string.argtypes = [I]
    lib.binary_dot_error_string.restype = ctypes.c_char_p
    return lib
