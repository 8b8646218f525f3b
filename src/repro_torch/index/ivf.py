"""IVF index over recurrent-binary codes with SDC fine scoring (ports
``repro/index/ivf.py``).

Build: k-means over grid values -> inverted lists, padded to a fixed list
length so search is a fixed-shape gather + masked SDC scan. The coarse
layer scores the centroids in float (or through their grid-quantised
codes with ``coarse_sdc``) as a plain product, as the reference leaves it
to XLA; the fine layer is the gather kernel (``kernels/sdc/gather.py``)
on CUDA tensors and its plain twin on CPU tensors. Lists can be stored
nibble-packed (``packed=True``, n_levels <= 4) at 2 dims/byte, halving
scan bytes with bit-identical scores. ``ivf_search_from_snapshot`` builds
an index from a corpus snapshot and returns a serving closure, under
nprobe or a probe budget, in bi-granular mode too (an IVF over the
level-prefix codes whose top-k' survivors are reranked on the full-level
codes).

The index lives on the device it is built on: ``device="cuda"`` by
default, raising when there is no card. ``ivf_from_numpy`` carries an
index built by the reference across.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.binarize_lib import (
    coarse_codes,
    codes_to_values,
    pack_codes_nibbles,
    values_to_codes,
)
from repro_torch.device import full_fp32_matmul, resolve_device
from repro_torch.index._snapshot import resolve_rerank_args, resolve_snapshot_args, split_effort
from repro_torch.index.flat import device_codes
from repro_torch.index.kmeans import kmeans
from repro_torch.kernels.sdc import ref as sdc_ref
from repro_torch.kernels.sdc.defaults import plan_for
from repro_torch.kernels.sdc.ops import sdc_gather_backend
from repro_torch.kernels.sdc.rerank import fine_inv_norms, sdc_rerank_backend


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor  # [nlist, D] float grid-space centroids
    centroid_codes: torch.Tensor  # [nlist, D] int8 grid-quantised centroids
    lists_codes: torch.Tensor  # [nlist, max_len, D] int8 (uint8 [.., D//2] packed)
    lists_inv_norm: torch.Tensor  # [nlist, max_len] f32 (0 for padding)
    lists_ids: torch.Tensor  # [nlist, max_len] int32 (-1 for padding)
    n_levels: int
    packed: bool = False  # nibble-packed list storage (2 dims/byte)
    # [nlist] int32 (numpy) stored entries per list, captured at build
    # time: the occupancy the budgeted probe allocator spends against.
    list_occupancy: object = None

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def code_dim(self) -> int:
        D = self.lists_codes.shape[-1]
        return D * 2 if self.packed else D

    def nbytes(self) -> int:
        packed = (self.code_dim * self.n_levels + 7) // 8
        n_eff = int((self.lists_ids >= 0).sum())
        return n_eff * (packed + 4 + 4) + self.centroids.numel() * 4


def bucket_lists(codes: torch.Tensor, inv: torch.Tensor, assign: torch.Tensor, *, nlist: int,
                 max_len: int | None = None, headroom: float = 1.0):
    """Bucket documents into padded inverted lists by their assignment.

    List c holds its documents in id order, the first ``max_len`` of them
    (``max_len`` defaults to the largest list, times ``headroom``); the
    rest are dropped with a warning. Returns (lists_codes [nlist, max_len,
    D] int8, lists_inv_norm [nlist, max_len] f32, lists_ids [nlist,
    max_len] int32, occupancy [nlist] numpy int32), on the device of
    ``codes``: the same arrays as the reference's per-document loop, from
    one stable sort.
    """
    n, D = codes.shape
    dev = codes.device
    assign = assign.to(dev, torch.int64)
    counts = torch.bincount(assign, minlength=nlist)
    counts_np = counts.cpu().numpy()
    if max_len is None:
        max_len = int(counts_np.max()) if n else 0
    max_len = max(1, int(np.ceil(max_len * headroom)))

    dropped = int(np.maximum(counts_np - max_len, 0).sum())
    if dropped:
        warnings.warn(
            f"build_ivf: {dropped}/{n} entries ({dropped / n:.2%}) dropped by "
            f"list overflow (max_len={max_len}, largest list={counts_np.max()}); "
            "raise max_len or headroom to keep them",
            stacklevel=3,
        )

    order = torch.sort(assign, stable=True).indices  # by list, then by id
    lst = assign[order]
    pos = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[lst]
    keep = pos < max_len
    doc, lst, pos = order[keep], lst[keep], pos[keep]
    lc = torch.zeros((nlist, max_len, D), dtype=torch.int8, device=dev)
    ln = torch.zeros((nlist, max_len), dtype=torch.float32, device=dev)
    li = torch.full((nlist, max_len), -1, dtype=torch.int32, device=dev)
    lc[lst, pos] = codes[doc].to(torch.int8)
    ln[lst, pos] = inv[doc].to(torch.float32)
    li[lst, pos] = doc.to(torch.int32)
    return lc, ln, li, np.minimum(counts_np, max_len).astype(np.int32)


def build_ivf(codes, *, n_levels: int, nlist: int, kmeans_iters: int = 20,
              max_len: int | None = None, headroom: float = 1.0, packed: bool = False,
              seed: int = 0, device="cuda") -> IVFIndex:
    """Cluster grid values, bucket codes into padded inverted lists, on ``device``.

    Args:
      max_len: fixed inverted-list capacity. Default (None) is the largest
        cluster size, which never drops an entry.
      headroom: multiplier applied to max_len.
      packed: store lists nibble-packed (requires n_levels <= 4).
      seed: the k-means++ draws come from ``prng.key(seed)``, the
        reference's ``PRNGKey(seed)`` stream; the same codes and seed
        rebuild the same index, bit for bit.

    Entries beyond a full list are dropped (they simply lose recall) and
    reported through ``warnings.warn`` with the dropped fraction.
    """
    if packed and n_levels > 4:
        raise ValueError(
            f"packed IVF lists need codes < 16 (n_levels <= 4), got {n_levels}"
        )
    dev = resolve_device(device)
    codes = torch.as_tensor(codes).to(dev, torch.int8)
    cents, assign = kmeans(codes_to_values(codes, n_levels), k=nlist, iters=kmeans_iters,
                           seed=seed, device=dev)
    lc, ln, li, occupancy = bucket_lists(codes, sdc_ref.doc_inv_norms(codes, n_levels), assign,
                                         nlist=nlist, max_len=max_len, headroom=headroom)
    return IVFIndex(
        centroids=cents,
        centroid_codes=values_to_codes(torch.clamp(cents, -2.0, 2.0), n_levels),
        lists_codes=pack_codes_nibbles(lc) if packed else lc,
        lists_inv_norm=ln,
        lists_ids=li,
        n_levels=n_levels,
        packed=packed,
        list_occupancy=occupancy,
    )


def ivf_from_numpy(*, centroids, centroid_codes, lists_codes, lists_inv_norm, lists_ids,
                   n_levels: int, packed: bool = False, list_occupancy=None,
                   device="cuda") -> IVFIndex:
    """The port's ``IVFIndex`` from the arrays of one the reference built
    (``np.asarray`` of each field), on ``device``."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(dev, dtype).contiguous()

    return IVFIndex(
        centroids=put(centroids, torch.float32),
        centroid_codes=put(centroid_codes, torch.int8),
        lists_codes=put(lists_codes, torch.uint8 if packed else torch.int8),
        lists_inv_norm=put(lists_inv_norm, torch.float32),
        lists_ids=put(lists_ids, torch.int32),
        n_levels=n_levels,
        packed=packed,
        list_occupancy=None if list_occupancy is None else np.asarray(list_occupancy, np.int32),
    )


def coarse_probes(q_codes, centroids, centroid_codes, *, nprobe: int, n_levels: int,
                  coarse_sdc: bool = False) -> torch.Tensor:
    """The ``nprobe`` best-scoring centroids of each query [Q, nprobe] int32,
    ties toward the lower centroid (``jax.lax.top_k``'s order)."""
    nlist = centroids.shape[0]
    if not 1 <= nprobe <= nlist:
        raise ValueError(f"nprobe must be in [1, {nlist}], got {nprobe}")
    full_fp32_matmul()
    vq = codes_to_values(q_codes, n_levels)
    cv = codes_to_values(centroid_codes, n_levels) if coarse_sdc else centroids
    coarse = vq @ cv.t()
    order = torch.sort(coarse, dim=1, descending=True, stable=True).indices
    return order[:, :nprobe].to(torch.int32)


def ivf_search(index_centroids, index_centroid_codes, lists_codes, lists_inv_norm, lists_ids,
               q_codes, *, nprobe: int, k: int, n_levels: int, coarse_sdc: bool = False,
               backend: str = "auto", packed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search [Q] queries; returns (scores [Q, k], doc ids [Q, k])."""
    probes = coarse_probes(q_codes, index_centroids, index_centroid_codes, nprobe=nprobe,
                           n_levels=n_levels, coarse_sdc=coarse_sdc)
    return sdc_gather_backend(q_codes, lists_codes, lists_inv_norm, lists_ids, probes,
                              n_levels=n_levels, k=k, backend=backend, packed=packed)


def probe_rank_thresholds(
    occupancy,
    *,
    probe_budget: int,
    nlist: int,
    weighted: bool = True,
):
    """Per-centroid coarse-rank thresholds spending ``probe_budget``.

    The budget is a total of per-centroid rank slots: a query probes
    list ``c`` iff ``c`` sits within that query's top-``r[c]`` coarse
    scores, so ``sum(r) == probe_budget`` and the *average* number of
    lists scanned per query is ``probe_budget / nlist`` (the coarse
    ranking is a permutation). Flat nprobe is the uniform special case
    ``r[c] == nprobe`` for all c, i.e. ``probe_budget == nprobe *
    nlist``.

    Allocation: every centroid gets the uniform floor ``probe_budget //
    nlist`` (the flat part), and the surplus ``probe_budget % nlist``
    rank slots are apportioned by largest remainder — proportional to
    list occupancy when ``weighted`` (heavy lists stay probed deeper
    into the coarse ranking, where the corpus mass actually sits), over
    equal weights otherwise (+1 to the lowest-index centroids: the
    equal-budget flat comparator). A budget that is an exact multiple
    of ``nlist`` therefore has zero surplus and reproduces flat nprobe
    exactly, occupancy-weighted or not — that is the parity case the
    tests pin. Thresholds are clipped to ``nlist`` (a rank past the end
    of the ranking buys nothing), which can strand surplus only when a
    single list's share exceeds the whole rank range.
    """
    B = int(probe_budget)
    n = int(nlist)
    if B < 1:
        raise ValueError(f"probe_budget must be >= 1, got {probe_budget}")
    base, surplus = divmod(B, n)
    r = np.full(n, min(base, n), np.int64)
    if surplus and base < n:
        if weighted and occupancy is not None:
            occ = np.asarray(occupancy, np.float64).reshape(-1)
            if occ.shape[0] != n:
                raise ValueError(
                    f"occupancy has {occ.shape[0]} entries for nlist={n}"
                )
            if occ.sum() <= 0:
                occ = np.ones(n)
        else:
            occ = np.ones(n)
        quota = surplus * occ / occ.sum()
        fl = np.floor(quota).astype(np.int64)
        r += fl
        rem = surplus - int(fl.sum())
        if rem > 0:
            # Largest fractional part first; ties break to the lower index
            # so the allocation is deterministic across replicas.
            order = np.lexsort((np.arange(n), -(quota - fl)))
            r[order[:rem]] += 1
    return np.minimum(r, n).astype(np.int32)


def ivf_search_budget(index_centroids, index_centroid_codes, lists_codes, lists_inv_norm,
                      lists_ids, rank_limits, q_codes, *, nprobe_max: int, k: int,
                      n_levels: int, coarse_sdc: bool = False, backend: str = "auto",
                      packed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Budgeted probe search: per-centroid coarse-rank thresholds.

    ``rank_limits`` is the [nlist] int32 threshold vector from
    ``probe_rank_thresholds``; ``nprobe_max`` must equal its max (it
    sizes the probe table). Probe column j of query q is live iff ``j <
    rank_limits[probes[q, j]]``; dead columns ride the gather kernel's
    candidate mask, a broadcast view over the list positions, so their
    lists never enter the running top-k.
    """
    probes = coarse_probes(q_codes, index_centroids, index_centroid_codes, nprobe=nprobe_max,
                           n_levels=n_levels, coarse_sdc=coarse_sdc)
    limits = torch.as_tensor(rank_limits, dtype=torch.int32, device=probes.device)
    cols = torch.arange(nprobe_max, dtype=torch.int32, device=probes.device)
    live = cols[None, :] < limits[probes.to(torch.int64)]
    mask = live[:, :, None].to(torch.float32).expand(-1, -1, lists_ids.shape[1])
    return sdc_gather_backend(q_codes, lists_codes, lists_inv_norm, lists_ids, probes,
                              n_levels=n_levels, k=k, backend=backend, packed=packed,
                              cand_mask=mask)


def _queries(index: IVFIndex, q_codes) -> torch.Tensor:
    return torch.as_tensor(q_codes).to(index.lists_codes.device, torch.int8).contiguous()


def search_budget(index: IVFIndex, q_codes, *, probe_budget: int, k: int,
                  weighted: bool = True, coarse_sdc: bool = False, backend: str = "auto"):
    """Search under a global probe budget instead of a flat nprobe.

    Uniform thresholds (every exact-multiple budget, or uniform
    occupancy) delegate to the flat ``search`` path with ``nprobe =
    probe_budget // nlist``, so ``probe_budget == nprobe * nlist`` is
    bit-identical to flat nprobe by construction. Non-uniform thresholds
    take the masked-probe path.
    """
    r = probe_rank_thresholds(
        index.list_occupancy if weighted else None,
        probe_budget=probe_budget, nlist=index.nlist, weighted=weighted,
    )
    lo, hi = int(r.min()), int(r.max())
    if lo == hi:
        return search(index, q_codes, nprobe=max(1, lo), k=k, coarse_sdc=coarse_sdc,
                      backend=backend)
    return ivf_search_budget(
        index.centroids, index.centroid_codes, index.lists_codes, index.lists_inv_norm,
        index.lists_ids, r, _queries(index, q_codes), nprobe_max=hi, k=k,
        n_levels=index.n_levels, coarse_sdc=coarse_sdc, backend=backend, packed=index.packed,
    )


def search(index: IVFIndex, q_codes, *, nprobe: int, k: int, coarse_sdc: bool = False,
           backend: str = "auto"):
    """Top-k IVF search of query codes [Q, m] (moved to the index's device)."""
    return ivf_search(
        index.centroids, index.centroid_codes, index.lists_codes, index.lists_inv_norm,
        index.lists_ids, _queries(index, q_codes), nprobe=nprobe, k=k,
        n_levels=index.n_levels, coarse_sdc=coarse_sdc, backend=backend, packed=index.packed,
    )


def ivf_search_from_snapshot(codes, n_levels: int = None, *, k: int, nlist: int, nprobe: int,
                             seed: int = 0, kmeans_iters: int = 20, max_len: int | None = None,
                             headroom: float = 1.0, packed: bool = False, backend: str = "auto",
                             coarse_sdc: bool = False, effort=None, rerank: dict | None = None,
                             probe_budget: int | None = None, block_plan=None, device="cuda"):
    """Rebuild-from-snapshot entry point: a serving closure ``codes -> (scores, ids)``.

    Clusters a snapshot's codes (anything with ``.codes`` and
    ``.n_levels``, or raw codes and ``n_levels``) into a fresh IVF index
    on ``device``. Deterministic: the k-means draws come from
    ``prng.key(seed)`` (the reference's ``PRNGKey(seed)``), so the same
    snapshot and parameters rebuild the same index, bit for bit.

    ``effort`` (anything with an int ``level``, 0 = full, e.g.
    ``launch.proxy.EffortKnob``) is read per call: level L serves with
    ``max(1, nprobe >> L)`` probes, or under ``max(1, probe_budget >>
    L)`` when a budget is set; level 0 is bit-identical to
    ``effort=None``. ``probe_budget`` switches probe selection to the
    occupancy-weighted allocator (``search_budget``; ``nprobe`` is then
    ignored).

    ``rerank={"coarse_levels": c, "k_coarse": k'}`` switches to
    bi-granular mode (``fn.reranked = True``): the IVF is clustered and
    scanned over the level-prefix codes at ``c`` levels, and each query's
    top-k' survivors are reranked on the full-level codes; numpy snapshot
    codes keep that fine tier on the host. ``effort`` then halves
    ``k_coarse`` first (floored at k, ``split_effort``) and applies only
    the residual levels to nprobe or the budget. ``block_plan`` reaches
    the rerank (its group size); the IVF scan's shape is the lists'.
    """
    codes, n_levels = resolve_snapshot_args(codes, n_levels)
    rr = resolve_rerank_args(rerank, n_levels)
    dev = resolve_device(device)
    if rr is None:
        index = build_ivf(device_codes(codes, dev), n_levels=n_levels, nlist=nlist,
                          kmeans_iters=kmeans_iters, max_len=max_len, headroom=headroom,
                          packed=packed, seed=seed, device=dev)

        def at_effort(value):
            return value if effort is None else max(1, value >> max(0, int(effort.level)))

        def fn(q):
            if probe_budget is not None:
                return search_budget(index, q, probe_budget=at_effort(probe_budget), k=k,
                                     coarse_sdc=coarse_sdc, backend=backend)
            return search(index, q, nprobe=at_effort(nprobe), k=k, coarse_sdc=coarse_sdc,
                          backend=backend)

        if effort is not None:
            fn.effort = effort
        return fn

    c_levels, k_coarse = rr
    full = device_codes(codes, dev)
    index = build_ivf(coarse_codes(full, n_levels, c_levels), n_levels=c_levels, nlist=nlist,
                      kmeans_iters=kmeans_iters, max_len=max_len, headroom=headroom,
                      packed=packed and c_levels <= 4, seed=seed, device=dev)
    fine = codes if isinstance(codes, np.ndarray) else full
    del full  # a host tier's device copy was only the coarse tier's source
    fine_inv = fine_inv_norms(fine, n_levels, device=dev)
    k_coarse = min(k_coarse, fine.shape[0])
    rerank_plan = plan_for(block_plan, "rerank")

    def fn(q):
        kc_eff, residual = (split_effort(effort.level, k=k, k_coarse=k_coarse)
                            if effort is not None else (k_coarse, 0))
        q = _queries(index, q)
        qc = coarse_codes(q, n_levels, c_levels)
        if probe_budget is not None:
            _, cand = search_budget(index, qc, probe_budget=max(1, probe_budget >> residual),
                                    k=kc_eff, coarse_sdc=coarse_sdc, backend=backend)
        else:
            _, cand = search(index, qc, nprobe=max(1, nprobe >> residual), k=kc_eff,
                             coarse_sdc=coarse_sdc, backend=backend)
        return sdc_rerank_backend(q, fine, fine_inv, cand, n_levels=n_levels, k=k,
                                  backend=backend, block_plan=rerank_plan)

    if effort is not None:
        fn.effort = effort
    fn.reranked = True
    return fn
