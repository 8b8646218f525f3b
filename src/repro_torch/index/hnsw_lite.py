"""HNSW-lite: a navigable-small-world graph with SDC distances (ports
``repro/index/hnsw_lite.py``).

A compact single-layer NSW (the HNSW fine layer), built on the host in
numpy, with the query-time distance evaluated through the same integer
identity as the SDC kernels. Two searchers:

  * ``search_hnsw`` — the numpy greedy best-first beam search (reference
    semantics, per query, host-side scoring).
  * ``search_hnsw_batched`` — the serving path: a batched-frontier beam
    search over fixed-shape tensors. Each hop expands the whole beam's
    neighbour table ([Q, beam, M] ids) into one candidate block, dedupes
    it against a per-query visited bitmap, and scores the block in one
    call of the gather search (``kernels/sdc/gather.py``): the CUDA
    ``sdc_gather_topk`` kernel on CUDA tensors, its plain twin on CPU
    tensors or with ``backend="torch"``. The graph is re-laid-out as
    neighbour blocks (node i's block holds its M neighbours' codes,
    norms and ids), so a hop is the IVF fine layer's access pattern with
    the beam as the probe table, int4 nibble-packed blocks included.

The reference runs the batched search as a ``lax.while_loop`` over a
fixed hop budget. Here it is a Python loop of tensor ops that reads on
the host, once a hop, whether any query is still active
(``hnsw_frontier_search.host_reads`` counts those reads): a hop in which
no query is active changes nothing, so stopping there gives the bits of
the full budget.

The graph build is the reference's, step for step, so the graph comes out
bit-identical: the same insertion order, the same float32 scores handed
to the same ``np.argsort`` (numpy's default sort is not stable, so among
tied scores its order is numpy's own; a different sort would give a
different graph). Only the arithmetic around it is rearranged: the codes
are put in insertion order once, so the already-inserted rows are a
prefix, and the exact integer code products of a block of steps come from
one float64 matrix product.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.binarize_lib import (
    SDC_NEG_INF,
    code_affine_constants,
    coarse_codes,
    pack_codes_nibbles,
)
from repro_torch.device import resolve_device
from repro_torch.index._snapshot import resolve_rerank_args, resolve_snapshot_args, split_effort
from repro_torch.index.flat import device_codes
from repro_torch.kernels.sdc.defaults import plan_for
from repro_torch.kernels.sdc.ops import resolve_backend, sdc_gather_backend, sdc_search_backend
from repro_torch.kernels.sdc.rerank import fine_inv_norms, sdc_rerank_backend
from repro_torch.kernels.sdc.sdc import merge_running_topk, select_topk

# build_hnsw scores this many query-corpus pairs at once (a block of steps
# against the rows inserted before the block ends), as float64
_BUILD_BLOCK_ELEMS = 1 << 23


def _unpack_rows_np(packed: np.ndarray) -> np.ndarray:
    """Nibble-packed uint8 [..., D//2] -> int8 codes [..., D] (numpy).

    Host-side inverse of ``binarize_lib.pack_codes_nibbles`` (byte j =
    dim 2j | dim 2j+1 << 4) for the numpy build/search paths.
    """
    p = packed.astype(np.uint8)
    out = np.empty((*p.shape[:-1], p.shape[-1] * 2), np.int8)
    out[..., 0::2] = (p & 0x0F).astype(np.int8)
    out[..., 1::2] = (p >> 4).astype(np.int8)
    return out


def _pack_rows_np(codes: np.ndarray) -> np.ndarray:
    """Integer codes [..., D] -> nibble-packed uint8 [..., D//2] (numpy)."""
    return pack_codes_nibbles(torch.from_numpy(np.ascontiguousarray(codes))).numpy()


@dataclasses.dataclass
class HNSWLite:
    codes: np.ndarray  # [N, D] int8, or nibble-packed uint8 [N, D//2]
    inv_norm: np.ndarray  # [N] f32
    neighbors: np.ndarray  # [N, M] int32 (-1 padded)
    entry: int
    n_levels: int
    packed: bool = False  # int4 nibble-packed code storage

    @property
    def code_dim(self) -> int:
        m = self.codes.shape[1]
        return 2 * m if self.packed else m

    def unpacked_codes(self) -> np.ndarray:
        return _unpack_rows_np(self.codes) if self.packed else self.codes

    def nbytes(self) -> int:
        """Index bytes as stored: codes + 4B norm per doc + the graph.

        Nibble-packed storage holds 4 bits per dim whatever n_levels is;
        unpacked storage is counted at the ideal n_levels bits per dim
        (as ``FlatSDC.nbytes``).
        """
        if self.packed:
            code_bytes = self.code_dim // 2  # 2 dims/byte in memory
        else:
            code_bytes = (self.code_dim * self.n_levels + 7) // 8
        return (
            self.codes.shape[0] * (code_bytes + 4) + self.neighbors.size * 4
        )


def _sdc_epilogue_np(dot, code_sums, *, dim: int, n_levels: int, inv_norm):
    """The SDC affine epilogue on numpy arrays, in float32.

    ``binarize_lib.sdc_affine_epilogue`` of the reference in its op order
    (mul, mul, add, add, then times ``inv_norm``); the Python-float
    constants stay float32 under numpy's scalar rules.
    """
    a, beta = code_affine_constants(n_levels)
    scores = (
        (a * a) * dot.astype(np.float32)
        + (a * beta) * code_sums.astype(np.float32)
        + dim * (beta * beta)
    )
    return scores * inv_norm


def _sdc_scores_np(q_code: np.ndarray, codes: np.ndarray, inv_norm: np.ndarray, n_levels: int):
    D = codes.shape[-1]
    dot = codes.astype(np.int32) @ q_code.astype(np.int32)
    sq = int(q_code.astype(np.int32).sum())
    sd = codes.astype(np.int32).sum(-1)
    return _sdc_epilogue_np(dot, sq + sd, dim=D, n_levels=n_levels, inv_norm=inv_norm)


class _PrefixScorer:
    """The scores ``_sdc_scores_np(codes[order[s]], codes[order[:s]], ...)``
    of build step s, computed a block of steps at a time.

    The codes are widened to float64 in insertion order once; a block's
    code products are one matrix product against the prefix of inserted
    rows (integer sums, exact in float64), the epilogue runs elementwise,
    so row s's first s entries hold the reference's float32 values.
    """

    def __init__(self, codes: np.ndarray, inv_norm: np.ndarray, order: np.ndarray,
                 n_levels: int):
        perm = codes[order]
        self.codes = perm.astype(np.float64)
        self.sums = perm.astype(np.int32).sum(-1)
        self.inv = inv_norm[order]
        self.dim = codes.shape[-1]
        self.n_levels = n_levels
        self.block = max(1, _BUILD_BLOCK_ELEMS // max(1, codes.shape[0]))
        self.start = self.stop = 0
        self.scores = None

    def __call__(self, step: int) -> np.ndarray:
        if not self.start <= step < self.stop:
            self.start, self.stop = step, min(step + self.block, self.codes.shape[0])
            cols = self.stop - 1
            dot = self.codes[self.start:self.stop] @ self.codes[:cols].T
            sums = self.sums[self.start:self.stop, None] + self.sums[None, :cols]
            self.scores = _sdc_epilogue_np(dot, sums, dim=self.dim, n_levels=self.n_levels,
                                           inv_norm=self.inv[:cols])
        return self.scores[step - self.start, :step]


def build_hnsw(
    codes: np.ndarray,
    inv_norm: np.ndarray,
    *,
    n_levels: int,
    M: int = 16,
    ef_construction: int = 64,
    seed: int = 0,
    packed: bool = False,
) -> HNSWLite:
    """Incremental NSW build: each point is connected to the M best results
    of a scan of the previously inserted points (host-side, O(N^2)).

    With ``packed=True`` (n_levels <= 4) the built index stores its codes
    nibble-packed: the graph itself is identical; only storage changes.
    """
    if packed and n_levels > 4:
        raise ValueError(
            f"packed HNSW codes need n_levels <= 4, got {n_levels}"
        )
    codes = np.asarray(codes)
    rng = np.random.default_rng(seed)
    n = codes.shape[0]
    neighbors = -np.ones((n, M), np.int32)
    order = rng.permutation(n)
    prefix_scores = _PrefixScorer(codes, inv_norm, order, n_levels)

    wide = codes.astype(np.int32)
    sums = wide.sum(-1)
    for step, idx in enumerate(order):
        if step <= M:
            cands = order[:step]
        else:
            top = np.argsort(-prefix_scores(step))[:ef_construction]
            cands = order[top]
        best = cands[:M]
        neighbors[idx, : len(best)] = best
        # Backlinks. The first M//2 slots are immutable once set: they were
        # created while the graph was sparse and act as the long-range
        # "navigable" edges (pruning them to a pure kNN graph traps greedy
        # search inside clusters); only the tail slots are re-ranked. The
        # rows of ``best`` are distinct, so they are updated together: a
        # row with a free slot takes idx in its first one, a full row keeps
        # the best of its tail and idx (each row argsorted on its own).
        rows = neighbors[best]
        free = rows < 0
        open_ = free.any(1)
        neighbors[best[open_], free[open_].argmax(1)] = idx
        full = best[~open_]
        if full.size:
            cand = np.concatenate(
                [rows[~open_, M // 2:], np.full((full.size, 1), idx, np.int32)], 1)
            dot = (wide[cand] * wide[full][:, None, :]).sum(-1)
            sc = _sdc_epilogue_np(dot, sums[full][:, None] + sums[cand], dim=codes.shape[-1],
                                  n_levels=n_levels, inv_norm=inv_norm[cand])
            keep = np.argsort(-sc, axis=-1)[:, : M - M // 2]
            neighbors[full, M // 2:] = np.take_along_axis(cand, keep, 1)

    entry = int(order[0])
    store = _pack_rows_np(codes) if packed else codes
    return HNSWLite(
        codes=store, inv_norm=inv_norm, neighbors=neighbors, entry=entry,
        n_levels=n_levels, packed=packed,
    )


def _entry_points(n: int, entry: int, n_entries: int, seed: int) -> np.ndarray:
    """Shared entry-point selection: graph entry + seeded random restarts.

    Both searchers draw from here, so the batched-frontier search explores
    from exactly the entry set of the numpy search.
    """
    rng = np.random.default_rng(seed)
    return np.unique(
        np.concatenate([[entry], rng.integers(0, n, max(n_entries - 1, 0))])
    ).astype(np.int64)


def search_hnsw(
    index: HNSWLite, q_code: np.ndarray, *, k: int, ef: int = 64,
    n_entries: int = 8, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy best-first beam search from multiple entry points (numpy
    reference; per query, host-side scoring).

    Returns (scores [k], ids [k])."""
    codes = index.unpacked_codes()
    n = codes.shape[0]
    entries = _entry_points(n, index.entry, n_entries, seed)
    e_scores = _sdc_scores_np(
        q_code, codes[entries], index.inv_norm[entries], index.n_levels
    )
    visited = set(int(e) for e in entries)
    # max-heap by score via negation
    frontier = [(-float(s), int(e)) for s, e in zip(e_scores, entries)]
    heapq.heapify(frontier)
    results = [(float(s), int(e)) for s, e in zip(e_scores, entries)]

    while frontier:
        neg, node = heapq.heappop(frontier)
        worst = min(results)[0] if len(results) >= ef else -np.inf
        if -neg < worst and len(results) >= ef:
            break
        neigh = index.neighbors[node]
        neigh = neigh[neigh >= 0]
        fresh = [int(x) for x in neigh if int(x) not in visited]
        if not fresh:
            continue
        visited.update(fresh)
        sub = np.asarray(fresh)
        scores = _sdc_scores_np(q_code, codes[sub], index.inv_norm[sub], index.n_levels)
        for s, i in zip(scores, sub):
            if len(results) < ef or s > min(results)[0]:
                heapq.heappush(frontier, (-float(s), int(i)))
                results.append((float(s), int(i)))
                if len(results) > ef:
                    results.remove(min(results))

    results.sort(reverse=True)
    top = results[:k]
    return (
        np.asarray([s for s, _ in top], np.float32),
        np.asarray([i for _, i in top], np.int32),
    )


# ---------------------------------------------------------------------------
# Batched-frontier search on the gather search.
#
# Node i's neighbour block holds the codes/norms/ids of its M neighbours
# ([N, M, D], [N, M], [N, M]): the IVF lists' layout with N lists of M
# rows, so a hop is one gather search with the beam as the probe table.
# The M-fold code duplication trades device bytes for one contiguous block
# per expanded node instead of M scattered rows; packed int4 storage claws
# half back.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchedHNSW:
    """Device-resident, fixed-shape HNSW tables for the batched searcher."""

    codes: torch.Tensor  # [N, D] int8 (uint8 [N, D//2] packed): entry scoring
    inv_norm: torch.Tensor  # [N] f32
    nbr_codes: torch.Tensor  # [N, M, D] int8 (uint8 [N, M, D//2] packed)
    nbr_inv: torch.Tensor  # [N, M] f32 (0 for -1 neighbour slots)
    nbr_ids: torch.Tensor  # [N, M] int32 (-1 padded)
    entry: int
    n_levels: int
    packed: bool = False

    @property
    def n(self) -> int:
        return self.nbr_ids.shape[0]

    @property
    def m(self) -> int:
        return self.nbr_ids.shape[1]

    def nbytes(self) -> int:
        """Device bytes of the search tables, the M-fold neighbour-block
        code duplication included: the serving footprint, distinct from
        ``HNSWLite.nbytes``, which counts the stored index."""
        return sum(
            t.numel() * t.element_size()
            for t in (self.codes, self.inv_norm, self.nbr_codes, self.nbr_inv, self.nbr_ids)
        )


def prepare_batched(index: HNSWLite, *, packed: Optional[bool] = None,
                    device="cuda") -> BatchedHNSW:
    """Expand an HNSWLite graph into gather-ready neighbour blocks on ``device``.

    ``packed`` overrides the index's storage layout for the device tables
    (None: inherit). Packing requires n_levels <= 4.
    """
    packed = index.packed if packed is None else packed
    if packed and index.n_levels > 4:
        raise ValueError(
            f"packed HNSW tables need n_levels <= 4, got {index.n_levels}"
        )
    dev = resolve_device(device)
    codes = index.unpacked_codes()
    nbr = index.neighbors.astype(np.int32)
    safe = np.where(nbr >= 0, nbr, 0)
    nbr_inv = np.where(nbr >= 0, index.inv_norm[safe], 0.0).astype(np.float32)

    def put(a):
        return torch.from_numpy(np.array(a)).to(dev)

    flat = put(codes).to(torch.int8)
    nbr_codes = flat[put(safe).to(torch.int64)]
    if packed:
        flat, nbr_codes = pack_codes_nibbles(flat), pack_codes_nibbles(nbr_codes)
    return BatchedHNSW(
        codes=flat.contiguous(),
        inv_norm=put(index.inv_norm).to(torch.float32),
        nbr_codes=nbr_codes.contiguous(),
        nbr_inv=put(nbr_inv),
        nbr_ids=put(nbr),
        entry=index.entry,
        n_levels=index.n_levels,
        packed=packed,
    )


def select_beam(res_vals, res_ids, expanded, beam: int) -> torch.Tensor:
    """A hop's beam [Q, beam] int32: the best results not yet expanded
    (ties toward the lower position, ``jax.lax.top_k``'s order), -1 where
    there are fewer."""
    rid_ok = res_ids >= 0
    rid = torch.where(rid_ok, res_ids, 0).to(torch.int64)
    frontier = torch.where(rid_ok & ~torch.gather(expanded, 1, rid), res_vals, SDC_NEG_INF)
    bvals, bpos = select_topk(frontier, beam)
    return torch.where(bvals > SDC_NEG_INF / 2,
                       torch.gather(res_ids, 1, bpos.clamp(min=0).to(torch.int64)), -1)


def expand_beam(beam_ids, active, nbr_ids, expanded, visited):
    """Expand a hop's beam: mark its nodes expanded, gather their neighbour
    ids and keep each fresh one once.

    ``expanded`` and ``visited`` are [Q, N + 1] bool bitmaps whose last
    column is a sink: a slot that must not be marked writes there, so every
    write to a real column is a True and repeated indices (every invalid
    slot clamps to node 0) cannot lose one. Returns (the beam clamped into
    range [Q, beam] int64, ``fresh`` [Q, beam * M] bool: valid, first in
    the block (a stable sort, then its inverse permutation), not visited
    before), and marks the fresh nodes visited.
    """
    Q, B = beam_ids.shape
    N, M = nbr_ids.shape
    beam_ok = (beam_ids >= 0) & active[:, None]
    bclamp = torch.where(beam_ok, beam_ids, 0).to(torch.int64)
    expanded.scatter_(1, torch.where(beam_ok, bclamp, N), True)
    flat = torch.where(beam_ok[..., None], nbr_ids[bclamp], -1).reshape(Q, B * M)
    valid = flat >= 0
    sorted_ids, order = torch.sort(flat, dim=1, stable=True)
    first = torch.ones_like(valid)
    first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    keep = torch.empty_like(first).scatter_(1, order, first)
    fclamp = torch.where(valid, flat, 0).to(torch.int64)
    fresh = valid & keep & ~torch.gather(visited, 1, fclamp)
    visited.scatter_(1, torch.where(fresh, fclamp, N), True)
    return bclamp, fresh


def hnsw_frontier_search(
    q_codes: torch.Tensor,
    codes: torch.Tensor,
    inv_norm: torch.Tensor,
    nbr_codes: torch.Tensor,
    nbr_inv: torch.Tensor,
    nbr_ids: torch.Tensor,
    entries: torch.Tensor,
    *,
    n_levels: int,
    k: int,
    ef: int,
    beam: int,
    max_hops: int,
    backend: str,
    packed: bool,
    early_exit: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched-frontier beam search over fixed-shape HNSW tables.

    State per query: a running top-``ef`` result list, a visited bitmap
    (each node scored once) and an expanded bitmap (each node's neighbour
    block streamed once). Each hop:

      1. beam <- the ``beam`` best unexpanded entries of the result list;
      2. candidate block <- the beam's neighbour tables ([Q, beam, M] ids);
      3. dedupe within the block and against the visited bitmap;
      4. score the block in one gather search (``backend`` "cuda": the
         kernel; "torch": its plain twin), keeping the fresh candidates'
         top-ef;
      5. merge into the running results (a stable sort, results first).

    Bitmaps are [Q, N + 1] (``expand_beam``). A query stays active while
    its beam holds a node; the search ends at ``max_hops``, or with
    ``early_exit`` at the first hop in which no query is active (read on
    the host, ``hnsw_frontier_search.host_reads`` counts the reads), which
    is where the reference's loop stops too. With ``early_exit=False``
    every one of the ``max_hops`` hops runs: the ones past that point
    change nothing.

    Args:
      q_codes: [Q, D] int8 query codes (unpacked, even when ``packed``).
      codes / inv_norm: flat corpus tables (entry-point scoring only).
      nbr_codes / nbr_inv / nbr_ids: neighbour-block tables ([N, M, ...]).
      entries: [E] integer entry node ids, -1 padded.

    Returns:
      (scores [Q, k], ids [Q, k], stats) with empty slots (SDC_NEG_INF,
      -1); stats carries per-query ``hops`` and ``scored`` counters.
    """
    Q = q_codes.shape[0]
    N, M = nbr_ids.shape
    E = entries.shape[0]
    dev = q_codes.device
    entries = entries.to(dev, torch.int64)

    # --- entry scoring (E docs per query) ---
    e_valid = entries >= 0
    e_ids = torch.where(e_valid, entries, 0)
    e_inv = torch.where(e_valid, inv_norm[e_ids], 0.0)
    res_vals, e_pos = sdc_search_backend(q_codes, codes[e_ids], e_inv, n_levels=n_levels, k=ef,
                                         backend=backend, packed=packed)
    res_ids = torch.where(e_pos >= 0, entries[e_pos.clamp(0, E - 1).to(torch.int64)],
                          -1).to(torch.int32)

    visited = torch.zeros((Q, N + 1), dtype=torch.bool, device=dev)
    visited[:, torch.where(e_valid, entries, N)] = True
    expanded = torch.zeros((Q, N + 1), dtype=torch.bool, device=dev)
    active = torch.ones(Q, dtype=torch.bool, device=dev)
    hops = torch.zeros(Q, dtype=torch.int32, device=dev)
    scored = torch.zeros(Q, dtype=torch.int32, device=dev)

    for _ in range(max_hops):
        beam_ids = select_beam(res_vals, res_ids, expanded, beam)
        active &= (beam_ids >= 0).any(-1)
        if early_exit:
            hnsw_frontier_search.host_reads += 1
            if not bool(active.any()):
                break
        bclamp, fresh = expand_beam(beam_ids, active, nbr_ids, expanded, visited)

        # Score the block (fresh candidates only).
        hop_vals, hop_ids = sdc_gather_backend(
            q_codes, nbr_codes, nbr_inv, nbr_ids, bclamp, n_levels=n_levels, k=ef,
            backend=backend, packed=packed,
            cand_mask=fresh.reshape(Q, beam, M).to(torch.float32))

        # Merge into the running top-ef (fresh-only scoring: no id twice).
        res_vals, res_ids = merge_running_topk(res_vals, res_ids, hop_vals, hop_ids, ef)
        hops += active.to(torch.int32)
        scored += fresh.sum(-1, dtype=torch.int32)

    stats = {"hops": hops, "scored": scored}
    return res_vals[:, :k], res_ids[:, :k], stats


hnsw_frontier_search.host_reads = 0


def search_hnsw_batched(
    index: BatchedHNSW,
    q_codes,
    *,
    k: int,
    ef: int = 64,
    beam: int = 8,
    max_hops: int = 64,
    n_entries: int = 8,
    seed: int = 0,
    backend: str = "auto",
    with_stats: bool = False,
    early_exit: bool = True,
):
    """Multi-query HNSW search on the gather search.

    Entry points match ``search_hnsw`` for the same (n_entries, seed), so
    the two searchers are directly comparable. ``backend`` follows the
    other indexes (``ops.resolve_backend``): "cuda" the kernels on CUDA
    tensors, "torch" the plain twins, "auto" the device of the tables.
    Queries move to the tables' device. ``early_exit`` as in
    ``hnsw_frontier_search``.

    Returns (scores [Q, k], ids [Q, k]), plus a stats dict of per-query
    ``hops`` and ``scored`` (candidates folded into the running top-k)
    when ``with_stats`` is set.
    """
    backend = resolve_backend(backend, index.codes.device)
    ef = max(ef, k)
    beam = max(1, min(beam, ef))
    ents = _entry_points(index.n, index.entry, n_entries, seed)
    padded = np.full((max(n_entries, 1),), -1, np.int64)
    padded[: len(ents)] = ents[: len(padded)]
    q = torch.as_tensor(q_codes).to(index.codes.device, torch.int8).contiguous()
    vals, ids, stats = hnsw_frontier_search(
        q,
        index.codes,
        index.inv_norm,
        index.nbr_codes,
        index.nbr_inv,
        index.nbr_ids,
        torch.from_numpy(padded),
        n_levels=index.n_levels,
        k=k,
        ef=ef,
        beam=beam,
        max_hops=max_hops,
        backend=backend,
        packed=index.packed,
        early_exit=early_exit,
    )
    if with_stats:
        return vals, ids, stats
    return vals, ids


def hnsw_search_from_snapshot(
    codes,
    n_levels: int = None,
    *,
    k: int,
    M: int = 16,
    ef_construction: int = 64,
    ef: int = 64,
    beam: int = 8,
    max_hops: int = 64,
    seed: int = 0,
    packed: bool = False,
    backend: str = "auto",
    effort=None,
    rerank: dict | None = None,
    block_plan=None,
    device="cuda",
):
    """Rebuild-from-snapshot entry point: a serving closure ``codes -> (scores, ids)``.

    Rebuilds the NSW graph from a snapshot's unpacked codes (anything with
    ``.codes`` and ``.n_levels``, or raw codes and ``n_levels``) on the
    host, O(N^2), and places its tables on ``device``. Deterministic: the
    insertion order derives from ``seed``, so the same snapshot and
    parameters rebuild the same graph, bit for bit.

    ``effort`` (anything with an int ``level``, 0 = full, e.g.
    ``launch.proxy.EffortKnob``) is read per call: level L serves with
    ``max(k, ef >> L)`` and ``max(1, beam >> L)``; level 0 is
    bit-identical to ``effort=None``.

    ``rerank={"coarse_levels": c, "k_coarse": k'}`` switches to
    bi-granular mode (``fn.reranked = True``): the graph is built and
    walked over the level-prefix codes at ``c`` levels (packed only when
    ``c <= 4``), and each query's top-k' survivors are reranked on the
    full-level codes; numpy snapshot codes keep that fine tier in host
    memory. ``effort`` then halves ``k_coarse`` first (floored at k,
    ``split_effort``) and applies only the residual levels to ef and beam.
    ``block_plan`` reaches the rerank (its group size); the walk's gather
    shape is the graph's, so scan and gather plans are inert.
    """
    codes, n_levels = resolve_snapshot_args(codes, n_levels)
    rr = resolve_rerank_args(rerank, n_levels)
    rerank_plan = plan_for(block_plan, "rerank")
    dev = resolve_device(device)
    host = codes.cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes)
    if rr is None:
        inv = fine_inv_norms(host, n_levels, device=dev)
        graph = build_hnsw(host, inv, n_levels=n_levels, M=M, ef_construction=ef_construction,
                           seed=seed, packed=packed)
        tables = prepare_batched(graph, device=dev)
        if effort is None:
            return lambda q: search_hnsw_batched(
                tables, q, k=k, ef=ef, beam=beam, max_hops=max_hops, backend=backend,
            )

        def fn(q):
            level = max(0, int(effort.level))
            return search_hnsw_batched(
                tables, q, k=k, ef=max(k, ef >> level), beam=max(1, beam >> level),
                max_hops=max_hops, backend=backend,
            )

        fn.effort = effort
        return fn

    c_levels, k_coarse = rr
    codes_c = coarse_codes(device_codes(host, "cpu"), n_levels, c_levels).numpy()
    inv_c = fine_inv_norms(codes_c, c_levels, device=dev)
    graph = build_hnsw(codes_c, inv_c, n_levels=c_levels, M=M, ef_construction=ef_construction,
                       seed=seed, packed=packed and c_levels <= 4)
    tables = prepare_batched(graph, device=dev)
    fine = codes if isinstance(codes, np.ndarray) else device_codes(codes, dev)
    fine_inv = fine_inv_norms(fine, n_levels, device=dev)
    k_coarse = min(k_coarse, host.shape[0])

    def fn(q):
        kc_eff, residual = (split_effort(effort.level, k=k, k_coarse=k_coarse)
                            if effort is not None else (k_coarse, 0))
        q = torch.as_tensor(q).to(dev, torch.int8).contiguous()
        qc = coarse_codes(q, n_levels, c_levels)
        _, cand = search_hnsw_batched(
            tables, qc, k=kc_eff, ef=max(kc_eff, ef >> residual),
            beam=max(1, beam >> residual), max_hops=max_hops, backend=backend,
        )
        return sdc_rerank_backend(q, fine, fine_inv, cand, n_levels=n_levels, k=k,
                                  backend=backend, block_plan=rerank_plan)

    if effort is not None:
        fn.effort = effort
    fn.reranked = True
    return fn


# ---------------------------------------------------------------------------
# Sharded build for the distributed engine: one NSW graph per leaf over that
# leaf's rows, the tables stacked along the document axis.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedHNSW:
    """Per-leaf HNSW tables stacked into global tensors (axis 0 shards)."""

    codes: torch.Tensor  # [N, D(/2)]
    inv_norm: torch.Tensor  # [N]
    nbr_codes: torch.Tensor  # [N, M, D(/2)]
    nbr_inv: torch.Tensor  # [N, M]
    nbr_ids: torch.Tensor  # [N, M] int32, leaf-local ids
    entries: torch.Tensor  # [n_leaves, E] int32, leaf-local ids (-1 padded)
    n_levels: int
    packed: bool = False


def build_hnsw_sharded(
    codes: np.ndarray,
    inv_norm: np.ndarray,
    *,
    n_leaves: int,
    n_levels: int,
    M: int = 16,
    ef_construction: int = 64,
    n_entries: int = 8,
    seed: int = 0,
    packed: bool = False,
    device="cuda",
) -> ShardedHNSW:
    """Build one NSW graph per leaf shard (host-side, seed + leaf) and stack
    the batched tables on ``device``.

    Neighbour ids and entries stay leaf-local; a leaf adds its shard base
    to the ids it returns.
    """
    n = codes.shape[0]
    if n % n_leaves != 0:
        raise ValueError(f"corpus size {n} not divisible by {n_leaves} leaves")
    dev = resolve_device(device)
    shard_n = n // n_leaves
    parts: List[BatchedHNSW] = []
    entries = np.full((n_leaves, n_entries), -1, np.int32)
    for leaf in range(n_leaves):
        lo = leaf * shard_n
        idx = build_hnsw(
            codes[lo : lo + shard_n],
            inv_norm[lo : lo + shard_n],
            n_levels=n_levels,
            M=M,
            ef_construction=ef_construction,
            seed=seed + leaf,
        )
        parts.append(prepare_batched(idx, packed=packed, device=dev))
        ents = _entry_points(shard_n, idx.entry, n_entries, seed + leaf)
        entries[leaf, : min(len(ents), n_entries)] = ents[:n_entries]

    def stack(field):
        return torch.cat([getattr(p, field) for p in parts], 0)

    return ShardedHNSW(
        codes=stack("codes"),
        inv_norm=stack("inv_norm"),
        nbr_codes=stack("nbr_codes"),
        nbr_inv=stack("nbr_inv"),
        nbr_ids=stack("nbr_ids"),
        entries=torch.from_numpy(entries).to(dev),
        n_levels=n_levels,
        packed=packed,
    )
