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
(the corpus, N * (D + 4) bytes, dwarfs everything else). Each block
scans one slice of the documents against a chunk of up to 16 queries
held in shared memory; the chunks of one slice run side by side, so the
slice is read from HBM about once. A round stages 256 rows with
``cp.async`` and scores them with one exact int8 tensor-core product
(``mma.sync``, ``csrc/tile_mma.cuh``); each block keeps a per-query
top-k of its slice in the selector of ``csrc/sdc_common.cuh``, and a
second kernel merges the slices. The source says more.

The fused kernel is built for code dims 32, 64, 128 and 256
(``KERNEL_DIMS``). Any other dim up to 256 runs at the next of them, its
codes padded with zeros (a code of 0 adds nothing to a product or a code
sum, and the epilogue keeps the real dim), which copies the corpus once
per call. ``sdc_topk`` on the card takes k up to ``K_MAX`` and code dims
up to 256 in the fused kernel; a larger k or dim runs the reference's
unfused route (``unfused_topk``: the ``sdc_scores`` kernel and a stable
sort, ``select_topk``, a chunk of queries at a time), chosen before any
launch and counted by ``sdc_scores.launches``. The plain versions take
any k and dim.

The kernel's launch geometry is chosen on the host (``scan_geometry``):
by default one full wave of blocks of up to 16 queries, each over one
slice of the corpus; a ``geometry=(block_q, block_n)`` (a tuned scan
``BlockPlan``, ``launch/autotune.py``) sets the queries a block holds and
the documents a slice holds instead, checked (``check_scan_blocks``) and
never clamped. Geometry changes no score and no id; the unfused routes
and the plain versions take none. ``sdc_topk.last_geometry`` is the
``(queries per block, slices, documents per slice)`` of the last launch.

Each wrapper also runs as a custom operator (``repro_torch::sdc_topk``,
``repro_torch::sdc_scores``) on meta tensors and under a dispatch mode,
with a fake and a FLOP formula, and ``sdc_topk`` on DTensors
(``parallel/spmd.py``) scores the corpus rows where they lie and takes the
top k of the gathered scores; ``register_sharding_strategies`` says more.

Both versions return what the reference's ``ops.sdc_search`` returns:
``(scores [Q, k] f32, ids [Q, k] int32)``, best first, ties toward the
lower id, and ``(SDC_NEG_INF, -1)`` in every slot without a candidate
(excluded documents, ``k > N``).

``sdc_scores`` (kernel ``csrc/sdc_scores.cu``, plain version
``sdc_scores_torch``) writes the whole [Q, N] score matrix instead, for
the unfused routes and the tests; it dispatches the same way, and its
kernel takes any code dim (padded with zero codes to a multiple of 32).
On the card the matrix's rows are padded to a multiple of 32 scores, so
that every row starts on a 128-byte line: it is a view of its first N
columns, contiguous only where N is a multiple of 32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.binarize_lib import (
    SDC_NEG_INF,
    code_affine_constants,
    sdc_affine_epilogue,
    unpack_nibble_planes,
)
from repro_torch.device import is_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels.sdc.ref import code_dot

# Largest k the fused kernel takes: a query's candidate buffer holds
# max(64, next_pow2(2k)) 64-bit keys in shared memory.
K_MAX = 4096
# Code dims the fused kernels are instantiated for; other dims up to the
# last are padded to the next of them, wider ones take the unfused route.
KERNEL_DIMS = (32, 64, 128, 256)
SCORES_DIM_STEP = 32  # sdc_scores.cu pads the code dim to a multiple of the mma's K
SCORES_ROW_STEP = 32  # sdc_scores.cu: the score matrix's rows padded to 128 bytes

_THREADS = 256  # documents per round, as in the source
_SCORES_QUERIES_PER_BLOCK = 64  # sdc_scores.cu: the most queries a block holds (kMaxQueries)
_SCORES_BLOCKS_PER_SM = 2  # sdc_scores.cu: blocks an SM its shared memory is sized for
_TOPK_QUERIES_PER_BLOCK = 16  # sdc_topk.cu: the most queries a scan block holds
_TOPK_BLOCKS_PER_SM = 3  # sdc_topk.cu: the scan's __launch_bounds__ minimum (kMinBlocks)
# Hopper's shared memory: 228 KB an SM, of which it keeps 1 KB for each
# block it runs (so one block may take 227 KB).
SMEM_SM, SMEM_RESERVED = 228 * 1024, 1024
_PLAIN_CHUNK = 1 << 18
# The unfused routes hold a [Qc, n] score matrix and sort it: a chunk of
# queries takes at most this share of the device memory that is free, at
# _SORT_BYTES bytes a score (the score, its sorted copy, the sort's int64
# indices, their iota and the sort's double buffers, about 40 bytes: 24
# ran out of memory on the card at 1,024 queries over ten million rows).
_UNFUSED_MEMORY_SHARE = 0.4
_SORT_BYTES = 48

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


def check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def sdc_topk(q_codes, d_codes, d_inv_norm, *, n_levels: int, k: int, packed: bool = False,
             geometry: tuple[int, int] | None = None):
    """Top-k SDC search: (scores [Q, k] f32, ids [Q, k] int32).

    ``q_codes`` [Q, D] int8; ``d_codes`` [N, D] int8, or nibble-packed
    uint8 [N, D//2] when ``packed``; ``d_inv_norm`` [N] f32, where a
    value that is not > 0 excludes its document. CUDA tensors run the
    kernel (``sdc_topk.launches`` counts its launches), CPU tensors the
    plain version. On CUDA tensors a k above ``K_MAX`` or a code dim
    above 256 runs ``unfused_topk`` instead (the same bits;
    ``sdc_scores.launches`` counts it), and a code dim that is not in
    ``KERNEL_DIMS`` is padded with zeros, a copy of the corpus.
    ``geometry=(block_q, block_n)`` sets the kernel's launch geometry
    (``scan_geometry``; an illegal one raises ValueError); the plain
    version and the unfused route take none.
    """
    _check_inputs(q_codes, d_codes, d_inv_norm, packed)
    check_k(k)
    if any(map(is_dtensor, (q_codes, d_codes, d_inv_norm))):
        # sharded (parallel/spmd.py): score the corpus rows where they lie,
        # gather the scores, take the top k, as GSPMD partitions the
        # reference's scoring and top_k
        return select_topk(sdc_scores(q_codes, d_codes, d_inv_norm, n_levels=n_levels,
                                      packed=packed), k)
    if q_codes.device.type == "meta" or (geometry is None and _dispatch_mode_active()):
        return _sdc_topk_op(q_codes, d_codes, d_inv_norm, n_levels, k, packed)
    return _sdc_topk(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k, packed=packed,
                     geometry=geometry)


def _sdc_topk(q_codes, d_codes, d_inv_norm, *, n_levels, k, packed, geometry=None):
    if q_codes.device.type == "cpu":
        return sdc_topk_torch(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k,
                              packed=packed)
    if q_codes.device.type != "cuda":
        raise ValueError(f"no SDC kernel for device {q_codes.device}")
    if k > K_MAX or q_codes.shape[1] > KERNEL_DIMS[-1]:
        return unfused_topk(sdc_scores, q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k,
                            packed=packed)
    return _launch(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k, packed=packed,
                   geometry=geometry)


sdc_topk.launches = 0
sdc_topk.last_geometry = None


def _dispatch_mode_active() -> bool:
    return torch._C._len_torch_dispatch_stack() > 0


def scan_flops(q_shape, d_shape, packed: bool) -> int:
    """The products of an SDC scan of Q queries over N documents of code dim
    D, as the reference's step counts its two ``dot_general``s: the q . d
    products (2 Q N D) and the code sums (2 N D, a product with ones)."""
    Q, D = q_shape
    N = d_shape[0]
    return 2 * Q * N * D + 2 * N * D


# The custom operators ``repro_torch::sdc_topk`` and ``repro_torch::sdc_scores``
# run the same routes as the wrappers (kernel on CUDA, plain version on
# CPU); their fakes give a meta tensor's result shapes, so a step runs on
# the meta device, and their FLOP formula (``scan_flops``) is registered
# with ``torch.utils.flop_counter``, so ``launch/hlo_cost`` counts them. A
# CPU or CUDA tensor goes through them only while a dispatch mode is active
# (a counter): otherwise their dispatch is skipped, as ``dot_interact``'s is.


@torch.library.custom_op("repro_torch::sdc_topk", mutates_args=())
def _sdc_topk_op(q_codes: torch.Tensor, d_codes: torch.Tensor, d_inv_norm: torch.Tensor,
                 n_levels: int, k: int, packed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return _sdc_topk(q_codes, d_codes, d_inv_norm, n_levels=n_levels, k=k, packed=packed)


@_sdc_topk_op.register_fake
def _sdc_topk_fake(q_codes, d_codes, d_inv_norm, n_levels, k, packed):
    Q = q_codes.shape[0]
    return (q_codes.new_empty((Q, k), dtype=torch.float32),
            q_codes.new_empty((Q, k), dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.sdc_topk)
def _sdc_topk_flops(q_shape, d_shape, inv_shape, n_levels, k, packed, *args, out_shape=None,
                    **kwargs) -> int:
    return scan_flops(q_shape, d_shape, packed)


def cap_for(k: int) -> int:
    """Keys in a query's candidate buffer for top-k: a power of two >= 2k."""
    return max(64, 1 << (2 * k - 1).bit_length())


def affine_terms(n_levels: int, D: int):
    """The epilogue's float32 constants (a*a, a*beta, D*beta^2) for the kernels."""
    a, beta = code_affine_constants(n_levels)
    return tuple(float(np.float32(x)) for x in (a * a, a * beta, D * (beta * beta)))


def kernel_dim(D: int) -> int:
    """The code dim a fused kernel runs a dim-D search at: the least of ``KERNEL_DIMS`` >= D."""
    for width in KERNEL_DIMS:
        if D <= width:
            return width
    raise ValueError(
        f"the fused CUDA SDC scans take code dims up to {KERNEL_DIMS[-1]}, got {D}: a 256-row "
        f"tile of wider rows leaves shared memory for one block an SM at D = 512 (the "
        f"scans are shaped for three) and for none past about D = 800; wider dims take "
        f"the unfused route"
    )


def scores_dim(D: int) -> int:
    """The code dim the ``sdc_scores`` kernel runs a dim-D matrix at: D rounded up to 32."""
    return -(-D // SCORES_DIM_STEP) * SCORES_DIM_STEP


def _pad_codes(codes: torch.Tensor, width: int) -> torch.Tensor:
    """``codes`` [..., w] with zero bytes appended up to ``width`` (a copy)."""
    if codes.shape[-1] == width:
        return codes
    return torch.nn.functional.pad(codes, (0, width - codes.shape[-1]))


def kernel_operands(q: torch.Tensor, codes: torch.Tensor, packed: bool, width: int | None = None):
    """Queries and corpus as the kernels read them: (qa, qb, codes).

    Query rows are int8, 4-byte aligned; packed corpora are scored against
    the even and odd dims split beforehand, otherwise ``qa`` and ``qb`` are
    both the queries. A code dim below ``width`` (default ``kernel_dim(D)``,
    which raises above the widest fused kernel) is padded with zero codes
    to it: query rows and corpus rows alike (for a packed corpus, zero
    bytes, two zero codes each), so the corpus is copied.
    """
    D = q.shape[1]
    width = kernel_dim(D) if width is None else width
    if packed:
        qa, qb = (_pad_codes(h, width // 2).contiguous() for h in (q[:, 0::2], q[:, 1::2]))
        return qa, qb, _pad_codes(codes, width // 2)
    q = _pad_codes(q, width).contiguous()
    if q.data_ptr() % 4:
        raise ValueError("q_codes must be 4-byte aligned")
    return q, q, _pad_codes(codes, width)


def _corpus_slices(N: int, blocks_per_sm: int, q_chunks: int, device, rows_min: int):
    """(n_slices, slice_docs): one full wave of blocks over the query chunks,
    slices a multiple of ``_THREADS`` documents and at least ``rows_min``."""
    wave = max(1, blocks_per_sm * _sm_count(device) // q_chunks)
    n_slices = max(1, min(wave, -(-N // rows_min)))
    slice_docs = -(-max(N, 1) // n_slices)
    slice_docs = -(-slice_docs // _THREADS) * _THREADS
    return max(1, -(-N // slice_docs)), slice_docs


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def topk_rows_min(k: int) -> int:
    """Documents a corpus slice of ``sdc_topk`` covers at least (or the whole
    corpus): each slice hands k partial keys to the merge."""
    return max(_THREADS, 8 * k)


_MAX_SLICES = 65535  # the scan grid's y dimension


def _scan_blocks_per_sm(D: int, packed: bool, k: int, qc: int, device) -> int:
    """Scan blocks of ``qc`` queries an SM holds at once (0: none fits)."""
    lib = _lib()
    with torch.cuda.device(device):
        per_sm = lib.sdc_topk_blocks_per_sm(kernel_dim(D), int(packed), cap_for(k), qc)
    if per_sm < 0:
        raise RuntimeError(f"sdc_topk cannot be scheduled: "
                           f"{lib.sdc_topk_error_string(-per_sm).decode()}")
    return per_sm


def check_scan_blocks(blocks, N: int, D: int, packed: bool, k: int, device) -> None:
    """Raise ValueError, naming the shapes, unless ``blocks = (block_q,
    block_n)`` is a legal ``sdc_topk`` geometry for N documents of code dim
    D at this k: 1 <= block_q <= 16 queries a block, whose shared memory
    fits on an SM; block_n documents a slice, a multiple of 256, in at most
    ceil(N / max(256, 8k)) slices (as many as the default sizing may make)
    and at most 65,535."""
    bq, bn = blocks
    where = (f"sdc_topk geometry (block_q={bq!r}, block_n={bn!r}) for N={N}, D={D}, k={k}, "
             f"packed={packed}")
    if not all(isinstance(b, int) and not isinstance(b, bool) for b in (bq, bn)):
        raise ValueError(f"{where}: blocks must be ints")
    if not 1 <= bq <= _TOPK_QUERIES_PER_BLOCK:
        raise ValueError(f"{where}: a scan block holds 1 to {_TOPK_QUERIES_PER_BLOCK} queries")
    if bn < _THREADS or bn % _THREADS:
        raise ValueError(f"{where}: a slice holds a positive multiple of {_THREADS} documents")
    n_slices, most = -(-N // bn), -(-N // topk_rows_min(k))
    if n_slices > max(1, most) or n_slices > _MAX_SLICES:
        raise ValueError(f"{where}: {n_slices} slices, more than the "
                         f"{min(max(1, most), _MAX_SLICES)} allowed (a slice covers at least "
                         f"{topk_rows_min(k)} documents)")
    if _scan_blocks_per_sm(D, packed, k, bq, device) == 0:
        smem = _lib().sdc_topk_scan_smem(kernel_dim(D), int(packed), cap_for(k), bq)
        raise ValueError(f"{where}: a block of {bq} queries ({smem} bytes of shared memory) "
                         f"does not fit on an SM")


def scan_geometry(Q: int, N: int, D: int, packed: bool, k: int, device,
                  blocks: tuple[int, int] | None = None) -> tuple[int, int, int]:
    """``sdc_topk``'s launch geometry ``(qc, n_slices, slice_docs)`` for Q >= 1
    queries over N documents: ceil(Q / qc) x n_slices scan blocks of qc
    queries, each over slice_docs documents.

    With ``blocks=None``, the default: qc as many queries as let three
    blocks share an SM (``_queries_per_block``, at most 16), and one full
    wave of blocks, slices a multiple of 256 documents and at least
    ``topk_rows_min(k)``. With ``blocks=(block_q, block_n)``, qc =
    min(Q, block_q) and slice_docs = block_n, checked by
    ``check_scan_blocks``.
    """
    if blocks is not None:
        check_scan_blocks(blocks, N, D, packed, k, device)
        bq, bn = blocks
        return min(Q, bq), max(1, -(-N // bn)), bn
    qc = min(Q, _queries_per_block(kernel_dim(D), packed, cap_for(k)))
    per_sm = _scan_blocks_per_sm(D, packed, k, qc, device)
    if per_sm == 0:
        raise RuntimeError("sdc_topk cannot be scheduled: no block fits")
    n_slices, slice_docs = _corpus_slices(N, per_sm, -(-Q // qc), device, topk_rows_min(k))
    return qc, n_slices, slice_docs


def scan_candidates(Q: int, N: int, D: int, packed: bool, k: int, device) -> list:
    """The ``(block_q, block_n)`` geometries the autotuner sweeps for Q
    queries a call, the default first (``scan_geometry``'s, with block_q the
    queries a block may hold, not cut to Q): queries per block in {the
    default's, 4, 8, 16} x one, two or four waves of blocks. Geometries
    that launch the same grid at Q are listed once."""
    qpb = _queries_per_block(kernel_dim(D), packed, cap_for(k))
    qc, _, slice_docs = scan_geometry(Q, N, D, packed, k, device)
    out, launched = [(qpb, slice_docs)], {(qc, slice_docs)}
    for bq in (qpb, 4, 8, 16):
        per_sm = _scan_blocks_per_sm(D, packed, k, bq, device)
        if per_sm == 0:
            continue
        wave = max(1, per_sm * _sm_count(device) // -(-Q // min(Q, bq)))
        for waves in (1, 2, 4):
            n_slices = max(1, min(wave * waves, -(-N // topk_rows_min(k)), _MAX_SLICES))
            per_slice = -(-max(N, 1) // n_slices)
            bn = -(-per_slice // _THREADS) * _THREADS
            if (min(Q, bq), bn) not in launched:
                launched.add((min(Q, bq), bn))
                out.append((bq, bn))
    return out


def _check_corpus(d: torch.Tensor, inv: torch.Tensor) -> None:
    if d.shape[0] >= 2**31 - _THREADS:
        raise ValueError(f"corpus of {d.shape[0]} documents exceeds int32 ids")
    for name, t in (("d_codes", d), ("d_inv_norm", inv)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d.data_ptr() % 16:
        raise ValueError("d_codes must be 16-byte aligned")


def _launch(q, d, inv, *, n_levels, k, packed, geometry=None):
    Q, D = q.shape
    N = d.shape[0]
    _check_corpus(d, inv)
    qa, qb, d = kernel_operands(q, d, packed)
    W = kernel_dim(D)
    vals = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    if Q == 0:
        return vals, ids

    lib = _lib()
    cap = cap_for(k)
    qc, n_slices, slice_docs = scan_geometry(Q, N, D, packed, k, q.device, geometry)
    partial = torch.empty((Q, n_slices, k), dtype=torch.int64, device=q.device)

    c1, c2, c3 = affine_terms(n_levels, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sdc_topk_launch(
            qa.data_ptr(), qb.data_ptr(), d.data_ptr(), inv.data_ptr(),
            partial.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            Q, N, W, int(packed), k, cap, qc, n_slices, slice_docs, c1, c2, c3, stream,
        )
    if err != 0:
        msg = lib.sdc_topk_error_string(err).decode()
        raise RuntimeError(f"sdc_topk launch failed: CUDA error {err} ({msg})")
    sdc_topk.launches += 1
    sdc_topk.last_geometry = (qc, n_slices, slice_docs)
    return vals, ids


def units_per_block(smem, max_units: int, min_blocks: int) -> int:
    """The most units (queries, or (query, probe) pairs), up to ``max_units``,
    for one scan block whose shared memory for n units is ``smem(n)`` bytes.

    As many as let ``min_blocks`` blocks share an SM, so that the barriers
    that end each selector round in one block hide behind the others' work;
    where not even one unit allows that (large k), fewer blocks, down to
    one. At k = K_MAX that is 1 unit. 0 where no block fits.
    """
    for blocks in range(min_blocks, 0, -1):
        budget = SMEM_SM // blocks - SMEM_RESERVED
        for n in range(max_units, 0, -1):
            if smem(n) <= budget:
                return n
    return 0


@functools.cache
def _queries_per_block(D: int, packed: bool, cap: int) -> int:
    """Queries a scan block holds: ``units_per_block`` of the kernel's shape."""
    lib = _lib()
    qc = units_per_block(lambda n: lib.sdc_topk_scan_smem(D, int(packed), cap, n),
                         _TOPK_QUERIES_PER_BLOCK, _TOPK_BLOCKS_PER_SM)
    if qc == 0:
        raise RuntimeError(f"sdc_topk: no scan block fits in shared memory (D={D}, cap={cap})")
    return qc


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

    Same inputs as ``sdc_topk``, any code dim; a document whose inverse
    norm is not > 0 scores SDC_NEG_INF. CUDA tensors run the kernel
    (``sdc_scores.launches`` counts its launches), whose result is a view
    of rows padded to a multiple of 32 scores; CPU tensors the plain
    version.
    """
    _check_inputs(q_codes, d_codes, d_inv_norm, packed)
    if any(map(is_dtensor, (q_codes, d_codes, d_inv_norm))) or q_codes.device.type == "meta" \
            or _dispatch_mode_active():
        return _sdc_scores_op(q_codes, d_codes, d_inv_norm, n_levels, packed)
    return _sdc_scores(q_codes, d_codes, d_inv_norm, n_levels=n_levels, packed=packed)


def _sdc_scores(q_codes, d_codes, d_inv_norm, *, n_levels, packed):
    if q_codes.device.type == "cpu":
        return sdc_scores_torch(q_codes, d_codes, d_inv_norm, n_levels=n_levels, packed=packed)
    if q_codes.device.type != "cuda":
        raise ValueError(f"no SDC kernel for device {q_codes.device}")
    Q, D = q_codes.shape
    N = d_codes.shape[0]
    _check_corpus(d_codes, d_inv_norm)
    W = scores_dim(D)
    qa, qb, d_codes = kernel_operands(q_codes, d_codes, packed, W)
    ldo = -(-max(N, 1) // SCORES_ROW_STEP) * SCORES_ROW_STEP
    out = torch.empty((Q, ldo), dtype=torch.float32, device=q_codes.device)[:, :N]
    if Q == 0 or N == 0:
        return out
    lib = _scores_lib()
    qc = min(Q, _scores_queries_per_block(W, packed))
    with torch.cuda.device(q_codes.device):
        per_sm = lib.sdc_scores_blocks_per_sm(W, int(packed), qc)
    if per_sm <= 0:
        msg = lib.sdc_scores_error_string(-per_sm).decode() if per_sm < 0 else "no block fits"
        raise RuntimeError(f"sdc_scores cannot be scheduled: {msg}")
    n_slices, slice_docs = _corpus_slices(N, per_sm, -(-Q // qc), q_codes.device, _THREADS)
    c1, c2, c3 = affine_terms(n_levels, D)
    with torch.cuda.device(q_codes.device):
        stream = torch.cuda.current_stream(q_codes.device).cuda_stream
        err = lib.sdc_scores_launch(
            qa.data_ptr(), qb.data_ptr(), d_codes.data_ptr(), d_inv_norm.data_ptr(),
            out.data_ptr(), Q, N, ldo, W, int(packed), qc, n_slices, slice_docs, c1, c2, c3,
            stream,
        )
    if err != 0:
        msg = lib.sdc_scores_error_string(err).decode()
        raise RuntimeError(f"sdc_scores launch failed: CUDA error {err} ({msg})")
    sdc_scores.launches += 1
    return out


sdc_scores.launches = 0


@torch.library.custom_op("repro_torch::sdc_scores", mutates_args=())
def _sdc_scores_op(q_codes: torch.Tensor, d_codes: torch.Tensor, d_inv_norm: torch.Tensor,
                   n_levels: int, packed: bool) -> torch.Tensor:
    # a custom operator's result may not alias: the kernel's is a view of padded rows
    return _sdc_scores(q_codes, d_codes, d_inv_norm, n_levels=n_levels,
                       packed=packed).contiguous()


@_sdc_scores_op.register_fake
def _sdc_scores_fake(q_codes, d_codes, d_inv_norm, n_levels, packed):
    return q_codes.new_empty((q_codes.shape[0], d_codes.shape[0]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.sdc_scores)
def _sdc_scores_flops(q_shape, d_shape, inv_shape, n_levels, packed, *args, out_shape=None,
                      **kwargs) -> int:
    return scan_flops(q_shape, d_shape, packed)


@functools.cache
def register_sharding_strategies() -> None:
    """The operators' DTensor sharding strategies (``parallel/spmd.py``
    registers them once a mesh is bound). ``sdc_scores``: the corpus rows
    (codes and inverse norms) sharded alike give the score columns sharded
    so, the queries whole; or everything replicated. ``sdc_topk``:
    replicated only (the top k of a piece is not a piece of the top k);
    ``sdc_topk`` on DTensors does not reach it: it runs ``sdc_scores``
    sharded and the top k of the gathered scores."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.sdc_scores.default)
    def _scores(q_codes, d_codes, d_inv_norm, n_levels, packed):
        return [([Shard(1)], [Replicate(), Shard(0), Shard(0), None, None]),
                ([Replicate()], [Replicate(), Replicate(), Replicate(), None, None])]

    @register_sharding(torch.ops.repro_torch.sdc_topk.default)
    def _topk(q_codes, d_codes, d_inv_norm, n_levels, k, packed):
        return [([Replicate(), Replicate()],
                 [Replicate(), Replicate(), Replicate(), None, None, None])]


@functools.cache
def _scores_queries_per_block(D: int, packed: bool) -> int:
    """Queries an ``sdc_scores`` block holds: ``units_per_block`` of the kernel's shape."""
    lib = _scores_lib()
    qc = units_per_block(lambda n: lib.sdc_scores_smem(D, int(packed), n),
                         _SCORES_QUERIES_PER_BLOCK, _SCORES_BLOCKS_PER_SM)
    if qc == 0:
        raise RuntimeError(f"sdc_scores: no block fits in shared memory (D={D})")
    return qc


@functools.cache
def _scores_lib() -> ctypes.CDLL:
    """The score-matrix kernel library (built on first use), its C functions declared."""
    lib = _build.load(_SCORES_SOURCE)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sdc_scores_launch.argtypes = [P] * 5 + [I] * 8 + [F] * 3 + [P]
    lib.sdc_scores_launch.restype = I
    lib.sdc_scores_smem.argtypes = [I, I, I]
    lib.sdc_scores_smem.restype = ctypes.c_size_t
    lib.sdc_scores_blocks_per_sm.argtypes = [I, I, I]
    lib.sdc_scores_blocks_per_sm.restype = I
    lib.sdc_scores_error_string.argtypes = [I]
    lib.sdc_scores_error_string.restype = ctypes.c_char_p
    return lib


def query_chunk(device, Q: int, bytes_per_query: int) -> int:
    """Queries an unfused route scores at once: all of them off the card; on
    it, as many as keep ``bytes_per_query`` each within
    ``_UNFUSED_MEMORY_SHARE`` of the free memory (the driver's free memory
    and the caching allocator's unused blocks), and at least one."""
    if device.type != "cuda":
        return max(Q, 1)
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return max(1, min(Q, int(free * _UNFUSED_MEMORY_SHARE) // max(1, bytes_per_query)))


def unfused_topk(scores_fn, q_codes, d_codes, d_inv_norm, *, n_levels: int, k: int,
                 packed: bool = False):
    """``select_topk`` of ``scores_fn``'s [Q, N] matrix (``sdc_scores`` or its
    plain version), a chunk of queries at a time (``query_chunk``): the
    reference's unfused search, in bounded memory."""
    Q, N = q_codes.shape[0], d_codes.shape[0]
    qc = query_chunk(q_codes.device, Q, max(N, k) * _SORT_BYTES)
    parts = [select_topk(scores_fn(q_codes[s:s + qc], d_codes, d_inv_norm, n_levels=n_levels,
                                   packed=packed), k)
             for s in range(0, max(Q, 1), qc)]
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])


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


def select_topk(scores: torch.Tensor, k: int):
    """Top-k of a score matrix [Q, N] in ``jax.lax.top_k``'s order.

    A stable descending sort, so ties go to the lower index
    (``torch.topk`` orders them otherwise); ``k > N`` pads with
    SDC_NEG_INF, and every slot scoring SDC_NEG_INF gets id -1.
    """
    Q, N = scores.shape
    if k > N:
        pad = torch.full((Q, k - N), SDC_NEG_INF, dtype=scores.dtype, device=scores.device)
        scores = torch.cat([scores, pad], 1)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    return vals, torch.where(vals > SDC_NEG_INF / 2, idx, -1)


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
    _check_inputs(q_codes, d_codes, d_inv_norm, packed)
    check_k(k)
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
