"""SDC scan of probed inverted lists + top-k (ports ``repro/kernels/sdc/gather.py``).

The IVF fine layer scores, for every query, the lists its coarse layer
probed. ``sdc_gather_topk`` dispatches on the device of its inputs: a
CUDA tensor goes to the hand-written Hopper kernel in
``csrc/gather_topk.cu``, a CPU tensor to ``sdc_gather_topk_torch``, the
plain PyTorch version of the same function. There is no other route: on
a CUDA tensor the kernel launches or the call raises.

The kernel replaces the TPU kernel ``sdc_gather_topk``
(``repro/kernels/sdc/gather.py``), which streams one (query, probe) list
at a time through VMEM. On the card that order would read each list once
for every pair that probes it, so the wrapper groups the (query, probe)
pairs by list (``gather_plan``) and a kernel block scans one list for up
to 16 of its pairs, three blocks to an SM. It stages each round of 256
rows in shared memory with ``cp.async`` and scores it against all of them
with one exact int8 tensor-core product (``mma.sync``,
``csrc/tile_mma.cuh``); the per-pair selector that follows is the shared
one of ``csrc/sdc_common.cuh``. ``csrc/gather_topk.cu`` says more.

The kernel takes code dims up to 256: any dim that is not one of
``sdc.KERNEL_DIMS`` is padded with zero codes to the next of them, which
copies the lists once per call (``sdc.kernel_operands``), and k up to
``K_MAX``. A larger k or dim on the card takes the unfused route,
``unfused_gather_topk``: the ``sdc_scores`` kernel scores every list
slot, ``select_probed_topk`` picks each query's probed slots from that
matrix and selects with a stable sort, a chunk of queries at a time
(``sdc_scores.launches`` counts it). The plain version takes any k and
dim.

Both versions return the reference's contract: ``(scores [Q, k] f32,
ids [Q, k] int32)``, best first, ties toward the earlier probe column
and then the lower list position (not the lower doc id), and
``(SDC_NEG_INF, -1)`` in every slot without a candidate (padding,
excluded or masked slots, ``k > nprobe * L``). The reference's Pallas
kernel returns the real ids of masked slots beside their ``-1e30``
scores; its jnp twin and this port return -1 there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.binarize_lib import SDC_NEG_INF, sdc_affine_epilogue, unpack_nibble_planes
from repro_torch.device import full_fp32_matmul
from repro_torch.kernels import _build
from repro_torch.kernels.sdc.sdc import (
    _SORT_BYTES,
    _THREADS,
    K_MAX,
    KERNEL_DIMS,
    affine_terms,
    cap_for,
    check_k,
    kernel_dim,
    kernel_operands,
    merge_running_topk,
    query_chunk,
    sdc_scores,
    select_topk,
    units_per_block,
)

_SOURCE = _build.SOURCES[1]
_MAX_PAIRS_PER_BLOCK = 16
_BLOCKS_PER_SM = 3  # the scan kernel's __launch_bounds__ minimum
_PARTIAL_BYTES = 1 << 28  # bound on the scan's per-slice partial keys
# Lists differ in length and in how many pairs probe them, so blocks differ
# in work: the grid is about this many waves of blocks of at least
# _MIN_SLICE_ROWS rows, which the card balances, rather than one wave that
# waits on its largest block.
_WAVES = 4
_MIN_SLICE_ROWS = 2048
_PLAIN_ELEMS = 1 << 25  # plain version: query x list codes scored at once


def _check_inputs(q, lists_codes, lists_inv_norm, lists_ids, probes, k, packed, cand_mask):
    if not isinstance(q, torch.Tensor) or q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError("q_codes must be an int8 tensor [Q, D]")
    Q, D = q.shape
    if lists_ids.dim() != 2 or lists_ids.dtype != torch.int32:
        raise ValueError("lists_ids must be int32 [nlist, L]")
    nlist, L = lists_ids.shape
    want = (torch.uint8, D // 2) if packed else (torch.int8, D)
    if tuple(lists_codes.shape) != (nlist, L, want[1]) or lists_codes.dtype != want[0]:
        raise ValueError(
            f"list codes {tuple(lists_codes.shape)} {lists_codes.dtype} do not match query "
            f"dim D={D}, packed={packed} (want {want[0]} [{nlist}, {L}, {want[1]}])"
        )
    if packed and D % 2:
        raise ValueError(f"packed codes need an even code dim, got {D}")
    if tuple(lists_inv_norm.shape) != (nlist, L) or lists_inv_norm.dtype != torch.float32:
        raise ValueError("lists_inv_norm must be float32 [nlist, L]")
    if probes.dim() != 2 or probes.shape[0] != Q or probes.dtype.is_floating_point:
        raise ValueError("probes must be an integer tensor [Q, nprobe]")
    if cand_mask is not None and tuple(cand_mask.shape) != (Q, probes.shape[1], L):
        raise ValueError(f"cand_mask must be [Q, nprobe, L] = {(Q, probes.shape[1], L)}")
    tensors = [q, lists_codes, lists_inv_norm, lists_ids, probes]
    if cand_mask is not None:
        tensors.append(cand_mask)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if nlist < 1:
        raise ValueError("the index has no lists")
    check_k(k)


def sdc_gather_topk(q_codes, lists_codes, lists_inv_norm, lists_ids, probes, *,
                    n_levels: int, k: int, packed: bool = False, cand_mask=None):
    """Block-gather search: the best k slots of each query's probed lists.

    Args:
      q_codes: [Q, D] int8 query codes (unpacked, even with packed lists).
      lists_codes: [nlist, L, D] int8, or [nlist, L, D//2] uint8 if packed.
      lists_inv_norm: [nlist, L] f32 reciprocal doc norms (0 for padding).
      lists_ids: [nlist, L] int32 global doc ids (-1 for padding).
      probes: [Q, nprobe] integer list ids to scan per query, clamped into
        range (callers with invalid slots must also zero ``cand_mask``).
      cand_mask: optional [Q, nprobe, L] per-slot inclusion mask (> 0
        keeps the slot); any strides, so a broadcast view costs nothing.

    Returns:
      (scores [Q, k], doc ids [Q, k]); empty slots are (SDC_NEG_INF, -1).
      CUDA tensors run the kernel (``sdc_gather_topk.launches`` counts its
      launches), or for k above ``K_MAX`` or a code dim above 256
      ``unfused_gather_topk`` (``sdc_scores.launches`` counts it); CPU
      tensors the plain version.
    """
    _check_inputs(q_codes, lists_codes, lists_inv_norm, lists_ids, probes, k, packed, cand_mask)
    args = (q_codes, lists_codes, lists_inv_norm, lists_ids, probes)
    if q_codes.device.type == "cpu":
        return sdc_gather_topk_torch(*args, n_levels=n_levels, k=k, packed=packed,
                                     cand_mask=cand_mask)
    if q_codes.device.type != "cuda":
        raise ValueError(f"no SDC gather kernel for device {q_codes.device}")
    if k > K_MAX or q_codes.shape[1] > KERNEL_DIMS[-1]:
        return unfused_gather_topk(*args, n_levels=n_levels, k=k, packed=packed,
                                   cand_mask=cand_mask)
    return _launch(*args, n_levels=n_levels, k=k, packed=packed, cand_mask=cand_mask)


sdc_gather_topk.launches = 0


def gather_plan(probes: torch.Tensor, nlist: int, qc: int):
    """Group the (query, probe) pairs by the list they probe.

    Pair ``i`` is ``(i // nprobe, i % nprobe)``. Returns ``order``
    [Q * nprobe] int32, the pairs sorted by clamped list (stable, so by
    pair within a list); ``pair_off`` [nlist + 1] int32, list c's pairs
    being ``order[pair_off[c]:pair_off[c + 1]]``; ``unit_off`` [nlist + 1]
    int32, list c's ``ceil(count / qc)`` units of at most qc pairs being
    numbered ``unit_off[c]`` to ``unit_off[c + 1] - 1``; and ``max_units``,
    a bound on ``unit_off[-1]`` known without reading the device.
    """
    pc = probes.reshape(-1).to(torch.int64).clamp(0, nlist - 1)
    order = torch.sort(pc, stable=True).indices.to(torch.int32)
    counts = torch.zeros(nlist, dtype=torch.int64, device=pc.device)
    counts.scatter_add_(0, pc, torch.ones_like(pc))
    pair_off = torch.zeros(nlist + 1, dtype=torch.int32, device=pc.device)
    unit_off = torch.zeros(nlist + 1, dtype=torch.int32, device=pc.device)
    pair_off[1:] = counts.cumsum(0)
    unit_off[1:] = ((counts + qc - 1) // qc).cumsum(0)
    P = pc.numel()
    return order, pair_off, unit_off, min(nlist, P) + -(-P // qc)


def _launch(q, lists, inv, ids, probes, *, n_levels, k, packed, cand_mask):
    Q, D = q.shape
    nlist, L = ids.shape
    nprobe = probes.shape[1]
    if nprobe * L >= 2**31:
        raise ValueError(f"nprobe * L = {nprobe * L} slots exceed the kernel's 31-bit slot ids")
    for name, t in (("lists_codes", lists), ("lists_inv_norm", inv), ("lists_ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lists.data_ptr() % 16:
        raise ValueError("lists_codes must be 16-byte aligned")
    if Q == 0 or nprobe == 0 or L == 0:
        return (torch.full((Q, k), SDC_NEG_INF, device=q.device),
                torch.full((Q, k), -1, dtype=torch.int32, device=q.device))
    vals = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    out_ids = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    qa, qb, lists = kernel_operands(q, lists, packed)
    W = kernel_dim(D)
    probes = probes.to(torch.int32).contiguous()

    lib = _lib()
    cap = cap_for(k)
    P = Q * nprobe
    qc = min(P, _pairs_per_block(W, packed, cap))
    order, pair_off, unit_off, max_units = gather_plan(probes, nlist, qc)
    masked = cand_mask is not None
    with torch.cuda.device(q.device):
        per_sm = lib.gather_topk_blocks_per_sm(W, int(packed), int(masked), cap, qc)
    if per_sm <= 0:
        msg = lib.gather_topk_error_string(-per_sm).decode() if per_sm < 0 else "no block fits"
        raise RuntimeError(f"sdc_gather_topk cannot be scheduled: {msg}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_slices = max(1, min(_WAVES * per_sm * sms // max_units, -(-L // _MIN_SLICE_ROWS),
                          _PARTIAL_BYTES // (P * k * 8)))
    rows = -(-L // n_slices)
    slice_rows = -(-rows // _THREADS) * _THREADS
    n_slices = -(-L // slice_rows)
    partial = torch.empty((P, n_slices, k), dtype=torch.int64, device=q.device)
    if masked:
        mask = cand_mask.to(torch.float32)
        mask_ptr, strides = mask.data_ptr(), mask.stride()
    else:
        mask, mask_ptr, strides = None, None, (0, 0, 0)

    c1, c2, c3 = affine_terms(n_levels, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.gather_topk_launch(
            qa.data_ptr(), qb.data_ptr(), lists.data_ptr(), inv.data_ptr(), ids.data_ptr(),
            probes.data_ptr(), order.data_ptr(), pair_off.data_ptr(), unit_off.data_ptr(),
            mask_ptr, *strides, partial.data_ptr(), vals.data_ptr(), out_ids.data_ptr(),
            Q, nlist, L, W, nprobe, int(packed), k, cap, qc, max_units, n_slices, slice_rows,
            c1, c2, c3, stream,
        )
    if err != 0:
        msg = lib.gather_topk_error_string(err).decode()
        raise RuntimeError(f"sdc_gather_topk launch failed: CUDA error {err} ({msg})")
    sdc_gather_topk.launches += 1
    return vals, out_ids


@functools.cache
def _pairs_per_block(D: int, packed: bool, cap: int) -> int:
    """(Query, probe) pairs a scan block holds: ``units_per_block`` of the kernel's shape."""
    lib = _lib()
    qc = units_per_block(lambda n: lib.gather_topk_scan_smem(D, int(packed), cap, n),
                         _MAX_PAIRS_PER_BLOCK, _BLOCKS_PER_SM)
    if qc == 0:
        raise RuntimeError(
            f"sdc_gather_topk: no scan block fits in shared memory (D={D}, cap={cap})")
    return qc


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built on first use), its C functions declared."""
    lib = _build.load(_SOURCE)
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.gather_topk_launch.argtypes = [P] * 10 + [LL] * 3 + [P] * 3 + [I] * 12 + [F] * 3 + [P]
    lib.gather_topk_launch.restype = I
    lib.gather_topk_scan_smem.argtypes = [I, I, I, I]
    lib.gather_topk_scan_smem.restype = ctypes.c_size_t
    lib.gather_topk_blocks_per_sm.argtypes = [I, I, I, I, I]
    lib.gather_topk_blocks_per_sm.restype = I
    lib.gather_topk_error_string.argtypes = [I]
    lib.gather_topk_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# The unfused route: the score matrix of every list slot, then a selection.
# ---------------------------------------------------------------------------


def select_probed_topk(scores, probes, lists_inv_norm, lists_ids, *, k: int, cand_mask=None):
    """The gather's top-k from the scores of every list slot.

    ``scores`` [Q, nlist * L] holds query q's score of list c's position
    pos at column ``c * L + pos``. Each query's probed slots are taken in
    slot order ``p * L + pos`` (probes clamped into range); a slot whose
    ``cand_mask`` is not > 0, whose id is < 0 or whose inverse norm is not
    > 0 scores SDC_NEG_INF; a stable descending sort (``select_topk``)
    keeps the best k, ties going to the earlier slot as in the kernel's
    keys; slots map to doc ids through ``lists_ids``, and every slot
    scoring SDC_NEG_INF to -1. Plain tensor code, on any device.
    """
    Q = scores.shape[0]
    nlist, L = lists_ids.shape
    pc = probes.to(torch.int64).clamp(0, nlist - 1)
    cols = (pc[:, :, None] * L + torch.arange(L, device=scores.device)).reshape(Q, -1)
    live = ((lists_inv_norm > 0) & (lists_ids >= 0))[pc]
    if cand_mask is not None:
        live &= cand_mask > 0
    picked = torch.where(live.reshape(Q, -1), torch.gather(scores, 1, cols), SDC_NEG_INF)
    vals, slots = select_topk(picked, k)
    ids = lists_ids.reshape(-1)[torch.gather(cols, 1, slots.clamp(min=0).to(torch.int64))]
    return vals, torch.where(slots >= 0, ids, -1)


def unfused_gather_topk(q_codes, lists_codes, lists_inv_norm, lists_ids, probes, *,
                        n_levels: int, k: int, packed: bool = False, cand_mask=None):
    """The gather search through ``sdc_scores`` and ``select_probed_topk``.

    Same contract and bits as ``sdc_gather_topk``, any k and code dim: a
    chunk of queries at a time (``sdc.query_chunk``), ``sdc_scores``
    scores the chunk against every slot of every list ([nlist * L] rows,
    the lists' codes and norms viewed flat), then ``select_probed_topk``
    selects. On CUDA tensors the score matrix is the kernel's.
    """
    Q = q_codes.shape[0]
    nlist, L = lists_ids.shape
    nprobe = probes.shape[1]
    dev = q_codes.device
    if Q == 0 or nprobe == 0 or L == 0:
        return (torch.full((Q, k), SDC_NEG_INF, device=dev),
                torch.full((Q, k), -1, dtype=torch.int32, device=dev))
    codes = lists_codes.reshape(nlist * L, -1)
    inv = lists_inv_norm.reshape(-1)
    per_query = 4 * nlist * L + max(nprobe * L, k) * (_SORT_BYTES + 16)
    qc = query_chunk(dev, Q, per_query)
    parts = []
    for s in range(0, Q, qc):
        scores = sdc_scores(q_codes[s:s + qc], codes, inv, n_levels=n_levels, packed=packed)
        mask = None if cand_mask is None else cand_mask[s:s + qc]
        parts.append(select_probed_topk(scores, probes[s:s + qc], lists_inv_norm, lists_ids,
                                        k=k, cand_mask=mask))
        del scores
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def _list_dot(q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int32 code products [Q, C] of q [Q, D] with codes [Q, C, D].

    float32 with TF32 off: every partial sum is an integer below 2^24.
    """
    full_fp32_matmul()
    prod = torch.bmm(codes.to(torch.float32), q.to(torch.float32)[:, :, None])
    return prod[:, :, 0].to(torch.int32)


def sdc_gather_topk_torch(q_codes, lists_codes, lists_inv_norm, lists_ids, probes, *,
                          n_levels: int, k: int, packed: bool = False, cand_mask=None,
                          chunk: int | None = None):
    """Plain PyTorch gather search, on any device; same contract as ``sdc_gather_topk``.

    The twin of the reference's ``sdc_gather_topk_xla``, without its
    [Q, nprobe, L, D] gather: it goes one probe column and ``chunk`` list
    positions at a time, merging each into a running top-k keyed by slot
    ``p * L + pos`` with the running entries first, and looks the doc ids
    up only at the end.
    """
    Q, D = q_codes.shape
    nlist, L = lists_ids.shape
    nprobe = probes.shape[1]
    dev = q_codes.device
    if nprobe == 0 or L == 0:
        return (torch.full((Q, k), SDC_NEG_INF, device=dev),
                torch.full((Q, k), -1, dtype=torch.int32, device=dev))
    if chunk is None:
        chunk = max(1, _PLAIN_ELEMS // max(1, Q * D))
    pc = probes.to(torch.int64).clamp(0, nlist - 1)
    sq = q_codes.to(torch.int32).sum(-1, keepdim=True)
    run_v = torch.empty((Q, 0), dtype=torch.float32, device=dev)
    run_s = torch.empty((Q, 0), dtype=torch.int64, device=dev)
    for p in range(nprobe):
        c = pc[:, p]
        for s in range(0, L, chunk):
            e = min(L, s + chunk)
            codes, inv, ids = lists_codes[c, s:e], lists_inv_norm[c, s:e], lists_ids[c, s:e]
            if packed:
                lo, hi = unpack_nibble_planes(codes)
                dot = _list_dot(q_codes[:, 0::2], lo) + _list_dot(q_codes[:, 1::2], hi)
                sd = lo.to(torch.int32).sum(-1) + hi.to(torch.int32).sum(-1)
            else:
                dot = _list_dot(q_codes, codes)
                sd = codes.to(torch.int32).sum(-1)
            scores = sdc_affine_epilogue(dot, sq + sd, dim=D, n_levels=n_levels, inv_norm=inv)
            live = (inv > 0) & (ids >= 0)
            if cand_mask is not None:
                live &= cand_mask[:, p, s:e] > 0
            scores = torch.where(live, scores, SDC_NEG_INF)
            slots = torch.arange(p * L + s, p * L + e, device=dev).expand(Q, -1)
            run_v, run_s = merge_running_topk(run_v, run_s, scores, slots, k)
    if run_v.shape[1] < k:
        pad = k - run_v.shape[1]
        run_v = torch.cat([run_v, torch.full((Q, pad), SDC_NEG_INF, device=dev)], 1)
        run_s = torch.cat([run_s, torch.zeros((Q, pad), dtype=torch.int64, device=dev)], 1)
    ids = lists_ids[torch.gather(pc, 1, run_s // L), run_s % L]
    return run_v, torch.where(run_v > SDC_NEG_INF / 2, ids, -1)
