"""SDC scans: fused scan + top-k and the unfused score matrix (ports
``sdc_topk`` and ``sdc_scores`` of ``repro/kernels/sdc/sdc.py``).

``sdc_topk`` dispatches on the device of its inputs: a CUDA tensor goes
to the hand-written Hopper kernel in ``csrc/sdc_topk.cu``, a CPU tensor
to ``sdc_topk_torch``, the plain PyTorch version of the same function.
There is no other route: on a CUDA tensor the kernel launches or the
call raises.

The kernel replaces the TPU kernel ``repro/kernels/sdc/sdc.py::sdc_topk``
(``_sdc_topk_kernel``, ``_sdc_topk_kernel_packed``,
``_merge_running_topk``). Its bound at the serving shapes is HBM bytes
(the corpus, N * (D + 4) bytes, dwarfs everything else), so it reads the
corpus once per call: each block scans one slice of the documents
against every query of the batch, held in shared memory, and keeps a
per-query top-k of its slice; a second kernel merges the slices. This
first version scores with ``__dp4a`` on the CUDA cores, which is what
it waits on at Q = 64; the source says more.

Both versions return what the reference's ``ops.sdc_search`` returns:
``(scores [Q, k] f32, ids [Q, k] int32)``, best first, ties toward the
lower id, and ``(SDC_NEG_INF, -1)`` in every slot without a candidate
(excluded documents, ``k > N``).

``sdc_scores`` (kernel ``csrc/sdc_scores.cu``, plain version
``sdc_scores_torch``) writes the whole [Q, N] score matrix instead, for
the unfused search and the tests; it dispatches the same way.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.binarize_lib import (
    SDC_NEG_INF,
    code_affine_constants,
    sdc_affine_epilogue,
    unpack_nibble_planes,
)
from repro_torch.kernels import _build
from repro_torch.kernels.sdc.ref import code_dot

# Largest k the kernel takes: a query's candidate buffer holds
# max(64, next_pow2(2k)) 64-bit keys in shared memory.
K_MAX = 4096
# Code dims the kernel is instantiated for.
KERNEL_DIMS = (32, 64, 128, 256)

_THREADS = 256  # documents per round, as in the source
_MAX_QUERIES_PER_BLOCK = 64
_SMEM_BUDGET = 200 * 1024
_PLAIN_CHUNK = 1 << 18

_SOURCE, _SCORES_SOURCE = _build.SOURCES[0], _build.SOURCES[2]


def _check_inputs(q_codes, d_codes, d_inv_norm, packed: bool):
    if not isinstance(q_codes, torch.Tensor) or q_codes.dim() != 2 or q_codes.dtype != torch.int8:
        raise ValueError("q_codes must be an int8 tensor [Q, D]")
    D = q_codes.shape[1]
    want = (torch.uint8, D // 2) if packed else (torch.int8, D)
    if d_codes.dim() != 2 or (d_codes.dtype, d_codes.shape[1]) != want:
        raise ValueError(
            f"document codes {tuple(d_codes.shape)} {d_codes.dtype} do not match "
            f"query dim D={D}, packed={packed} (want {want[0]} [N, {want[1]}])"
        )
    if packed and D % 2:
        raise ValueError(f"packed codes need an even code dim, got {D}")
    if d_inv_norm.dim() != 1 or d_inv_norm.dtype != torch.float32 \
            or d_inv_norm.shape[0] != d_codes.shape[0]:
        raise ValueError("d_inv_norm must be float32 [N]")
    if not (q_codes.device == d_codes.device == d_inv_norm.device):
        raise ValueError(
            f"inputs on different devices: {q_codes.device}, {d_codes.device}, "
            f"{d_inv_norm.device}"
        )


def _check_k(k: int) -> None:
    if k < 1 or k > K_MAX:
        raise ValueError(f"k must be in [1, {K_MAX}], got {k}")


def sdc_topk(q_codes, d_codes, d_inv_norm, *, n_levels: int, k: int, packed: bool = False):
    """Top-k SDC search: (scores [Q, k] f32, ids [Q, k] int32).

    ``q_codes`` [Q, D] int8; ``d_codes`` [N, D] int8, or nibble-packed
    uint8 [N, D//2] when ``packed``; ``d_inv_norm`` [N] f32, where a
    value that is not > 0 excludes its document. CUDA tensors run the
    kernel (``sdc_topk.launches`` counts its launches), CPU tensors the
    plain version.
    """
    _check_inputs(q_codes, d_codes, d_inv_norm, packed)
    _check_k(k)
    if q_codes.device.type == "cpu":
        return sdc_topk_torch(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k,
                              packed=packed)
    if q_codes.device.type != "cuda":
        raise ValueError(f"no SDC kernel for device {q_codes.device}")
    return _launch(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k, packed=packed)


sdc_topk.launches = 0


def cap_for(k: int) -> int:
    """Keys in a query's candidate buffer for top-k: a power of two >= 2k."""
    return max(64, 1 << (2 * k - 1).bit_length())


def affine_terms(n_levels: int, D: int):
    """The epilogue's float32 constants (a*a, a*beta, D*beta^2) for the kernels."""
    a, beta = code_affine_constants(n_levels)
    return tuple(float(np.float32(x)) for x in (a * a, a * beta, D * (beta * beta)))


def kernel_queries(q: torch.Tensor, packed: bool):
    """Query codes as the kernels read them: (qa, qb), int8 rows, 4-byte aligned.

    Packed corpora are scored against the even and odd dims split
    beforehand; otherwise both are ``q``. Raises on a code dim no kernel
    is built for.
    """
    D = q.shape[1]
    if D not in KERNEL_DIMS:
        raise ValueError(f"the CUDA SDC kernels take code dims {KERNEL_DIMS}, got {D}")
    if packed:
        return q[:, 0::2].contiguous(), q[:, 1::2].contiguous()
    q = q.contiguous()
    if q.data_ptr() % 4:
        raise ValueError("q_codes must be 4-byte aligned")
    return q, q


def _corpus_slices(N: int, blocks_per_sm: int, q_chunks: int, device, rows_min: int):
    """(n_slices, slice_docs): one full wave of blocks over the query chunks,
    slices a multiple of ``_THREADS`` documents and at least ``rows_min``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave = max(1, blocks_per_sm * sms // q_chunks)
    n_slices = max(1, min(wave, -(-N // rows_min)))
    slice_docs = -(-max(N, 1) // n_slices)
    slice_docs = -(-slice_docs // _THREADS) * _THREADS
    return max(1, -(-N // slice_docs)), slice_docs


def _check_corpus(d: torch.Tensor, inv: torch.Tensor) -> None:
    if d.shape[0] >= 2**31 - _THREADS:
        raise ValueError(f"corpus of {d.shape[0]} documents exceeds int32 ids")
    for name, t in (("d_codes", d), ("d_inv_norm", inv)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d.data_ptr() % 16:
        raise ValueError("d_codes must be 16-byte aligned")


def _launch(q, d, inv, *, n_levels, k, packed):
    Q, D = q.shape
    N = d.shape[0]
    _check_corpus(d, inv)
    qa, qb = kernel_queries(q, packed)
    vals = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    if Q == 0:
        return vals, ids

    lib = _lib()
    cap = cap_for(k)
    per_query = lib.sdc_topk_scan_smem(D, int(packed), cap, 1)
    qc = max(1, min(Q, _MAX_QUERIES_PER_BLOCK, _SMEM_BUDGET // per_query))
    with torch.cuda.device(q.device):
        per_sm = lib.sdc_topk_blocks_per_sm(D, int(packed), cap, qc)
    if per_sm <= 0:
        msg = lib.sdc_topk_error_string(-per_sm).decode() if per_sm < 0 else "no block fits"
        raise RuntimeError(f"sdc_topk cannot be scheduled: {msg}")
    n_slices, slice_docs = _corpus_slices(N, per_sm, -(-Q // qc), q.device, max(_THREADS, 8 * k))
    partial = torch.empty((Q, n_slices, k), dtype=torch.int64, device=q.device)

    c1, c2, c3 = affine_terms(n_levels, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sdc_topk_launch(
            qa.data_ptr(), qb.data_ptr(), d.data_ptr(), inv.data_ptr(),
            partial.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            Q, N, D, int(packed), k, cap, qc, n_slices, slice_docs, c1, c2, c3, stream,
        )
    if err != 0:
        msg = lib.sdc_topk_error_string(err).decode()
        raise RuntimeError(f"sdc_topk launch failed: CUDA error {err} ({msg})")
    sdc_topk.launches += 1
    return vals, ids


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built on first use), its C functions declared."""
    lib = _build.load(_SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sdc_topk_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                                    F, F, F, P]
    lib.sdc_topk_launch.restype = I
    lib.sdc_topk_scan_smem.argtypes = [I, I, I, I]
    lib.sdc_topk_scan_smem.restype = ctypes.c_size_t
    lib.sdc_topk_blocks_per_sm.argtypes = [I, I, I, I]
    lib.sdc_topk_blocks_per_sm.restype = I
    lib.sdc_topk_error_string.argtypes = [I]
    lib.sdc_topk_error_string.restype = ctypes.c_char_p
    return lib


def sdc_scores(q_codes, d_codes, d_inv_norm, *, n_levels: int, packed: bool = False):
    """SDC score matrix [Q, N] f32 = <v(q), v(d)> / ||v(d)||.

    Same inputs as ``sdc_topk``; a document whose inverse norm is not
    > 0 scores SDC_NEG_INF. CUDA tensors run the kernel
    (``sdc_scores.launches`` counts its launches), CPU tensors the plain
    version.
    """
    _check_inputs(q_codes, d_codes, d_inv_norm, packed)
    if q_codes.device.type == "cpu":
        return sdc_scores_torch(q_codes, d_codes, d_inv_norm, n_levels=n_levels, packed=packed)
    if q_codes.device.type != "cuda":
        raise ValueError(f"no SDC kernel for device {q_codes.device}")
    Q, D = q_codes.shape
    N = d_codes.shape[0]
    _check_corpus(d_codes, d_inv_norm)
    qa, qb = kernel_queries(q_codes, packed)
    out = torch.empty((Q, N), dtype=torch.float32, device=q_codes.device)
    if Q == 0 or N == 0:
        return out
    lib = _scores_lib()
    qc = min(Q, _MAX_QUERIES_PER_BLOCK)
    with torch.cuda.device(q_codes.device):
        per_sm = lib.sdc_scores_blocks_per_sm(D, int(packed), qc)
    if per_sm <= 0:
        msg = lib.sdc_scores_error_string(-per_sm).decode() if per_sm < 0 else "no block fits"
        raise RuntimeError(f"sdc_scores cannot be scheduled: {msg}")
    n_slices, slice_docs = _corpus_slices(N, per_sm, -(-Q // qc), q_codes.device, _THREADS)
    c1, c2, c3 = affine_terms(n_levels, D)
    with torch.cuda.device(q_codes.device):
        stream = torch.cuda.current_stream(q_codes.device).cuda_stream
        err = lib.sdc_scores_launch(
            qa.data_ptr(), qb.data_ptr(), d_codes.data_ptr(), d_inv_norm.data_ptr(),
            out.data_ptr(), Q, N, D, int(packed), qc, n_slices, slice_docs, c1, c2, c3, stream,
        )
    if err != 0:
        msg = lib.sdc_scores_error_string(err).decode()
        raise RuntimeError(f"sdc_scores launch failed: CUDA error {err} ({msg})")
    sdc_scores.launches += 1
    return out


sdc_scores.launches = 0


@functools.cache
def _scores_lib() -> ctypes.CDLL:
    """The score-matrix kernel library (built on first use), its C functions declared."""
    lib = _build.load(_SCORES_SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sdc_scores_launch.argtypes = [P] * 5 + [I] * 7 + [F] * 3 + [P]
    lib.sdc_scores_launch.restype = I
    lib.sdc_scores_blocks_per_sm.argtypes = [I, I, I]
    lib.sdc_scores_blocks_per_sm.restype = I
    lib.sdc_scores_error_string.argtypes = [I]
    lib.sdc_scores_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def merge_running_topk(run_v, run_i, vals, ids, k: int):
    """Merge a chunk's (vals [Q, n], ids [Q, n]) into a running top-k.

    The running entries go first and the sort is stable, so among equal
    scores the earlier (lower-id) document wins, as ``jax.lax.top_k``
    orders them. ``torch.topk`` does not keep that order.
    """
    cat_v = torch.cat([run_v, vals], dim=1)
    cat_i = torch.cat([run_i, ids], dim=1)
    order = torch.sort(cat_v, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(cat_v, 1, order), torch.gather(cat_i, 1, order)


def _plain_scores(q_codes, sq, d_codes, inv, *, n_levels: int, packed: bool):
    """Scores [Q, n] of one chunk of documents; ``sq`` [Q, 1] the query code sums."""
    if packed:
        lo, hi = unpack_nibble_planes(d_codes)
        dot = code_dot(q_codes[:, 0::2], lo) + code_dot(q_codes[:, 1::2], hi)
        sd = lo.to(torch.int32).sum(-1) + hi.to(torch.int32).sum(-1)
    else:
        dot = code_dot(q_codes, d_codes)
        sd = d_codes.to(torch.int32).sum(-1)
    scores = sdc_affine_epilogue(dot, sq + sd[None, :], dim=q_codes.shape[1], n_levels=n_levels,
                                 inv_norm=inv[None, :])
    return torch.where(inv[None, :] > 0, scores, SDC_NEG_INF)


def sdc_topk_torch(q_codes, d_codes, d_inv_norm, *, n_levels: int, k: int,
                   packed: bool = False, chunk: int = _PLAIN_CHUNK):
    """Plain PyTorch top-k SDC search, on any device; same contract as ``sdc_topk``.

    Goes over the corpus ``chunk`` documents at a time with a running
    ``[Q, k]`` merge, so a corpus of ten million documents fits.
    """
    Q = q_codes.shape[0]
    N = d_codes.shape[0]
    dev = q_codes.device
    sq = q_codes.to(torch.int32).sum(-1, keepdim=True)
    run_v = torch.empty((Q, 0), dtype=torch.float32, device=dev)
    run_i = torch.empty((Q, 0), dtype=torch.int32, device=dev)
    for s in range(0, N, chunk):
        scores = _plain_scores(q_codes, sq, d_codes[s:s + chunk], d_inv_norm[s:s + chunk],
                               n_levels=n_levels, packed=packed)
        ids = torch.arange(s, s + scores.shape[1], dtype=torch.int32, device=dev)
        run_v, run_i = merge_running_topk(run_v, run_i, scores, ids.expand(Q, -1), k)
    if run_v.shape[1] < k:
        pad = k - run_v.shape[1]
        run_v = torch.cat([run_v, torch.full((Q, pad), SDC_NEG_INF, device=dev)], 1)
        run_i = torch.cat([run_i, torch.full((Q, pad), -1, dtype=torch.int32, device=dev)], 1)
    run_i = torch.where(run_v > SDC_NEG_INF / 2, run_i, -1)
    return run_v, run_i


def sdc_scores_torch(q_codes, d_codes, d_inv_norm, *, n_levels: int, packed: bool = False,
                     chunk: int = _PLAIN_CHUNK):
    """Plain PyTorch SDC score matrix [Q, N], on any device; same contract as ``sdc_scores``."""
    Q, N = q_codes.shape[0], d_codes.shape[0]
    sq = q_codes.to(torch.int32).sum(-1, keepdim=True)
    out = torch.empty((Q, N), dtype=torch.float32, device=q_codes.device)
    for s in range(0, N, chunk):
        out[:, s:s + chunk] = _plain_scores(q_codes, sq, d_codes[s:s + chunk],
                                            d_inv_norm[s:s + chunk], n_levels=n_levels,
                                            packed=packed)
    return out
