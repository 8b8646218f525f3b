"""Distributed BEBR search engine (ports ``repro/index/engine.py``; paper
Figure 5: proxy -> leaf -> merge).

The corpus codes are split into contiguous row shards, one per leaf of a
``launch/mesh.LeafMesh``; the queries go to every leaf ("proxy
dispatch"); each leaf runs a local SDC scan + top-k on its own device;
the per-leaf top-k lists come to the queries' device, are concatenated
and merged there ("selection merge").

The reference runs its leaves as the devices of a ``shard_map`` and
gathers their top-k with an ``all_gather``. Here one process drives every
leaf in turn, as JAX's single controller does. A leaf on the queries'
device reads views of the global tensors; a leaf on another device has
its own copy, and its top-k crosses to the queries' device (Q * k * 8
bytes a leaf: the paper's communication, independent of corpus size).

Leaves score through ``kernels/sdc/ops``, the substrate of ``FlatSDC``
and IVF: on a card each flat leaf is one ``sdc_topk`` launch over its
shard (``sdc_scores`` only on the unfused routes, k > 4096 or a code dim
above 256), each HNSW leaf hop one ``sdc_gather_topk`` launch; on the CPU,
or with ``backend="torch"``, the plain twins. ``packed=True`` shards a
nibble-packed uint8 [N, D//2] corpus.

The merge concatenates the leaves' lists in the order of the reference's
``all_gather``s, one over each sharded axis in turn, so the last sharded
axis is the outermost: ranks 0, 2, 4, 6, 1, 3, 5, 7 on a (4, 2) mesh
(``gather_order``). A stable descending sort then breaks ties toward the
earlier position (``jax.lax.top_k``'s order), and each leaf breaks them
toward the lower local id. Over one sharded axis the gather order is the
rank order, and when every slot is live the merge equals a flat search
over the whole corpus, ties included; over several it does unless equal
scores fall in two leaves that the gather order takes out of rank order.
Empty slots come out as -inf with id -1 (the engine's sentinel, not the
kernels' SDC_NEG_INF).

Three leaf index types share the proxy/merge skeleton:
  * flat — exhaustive leaf scan (``make_distributed_search``);
  * flat + failover mask (``make_failover_search``);
  * hnsw — batched-frontier graph search per leaf (``make_hnsw_search``),
    one NSW graph per shard built on the host by
    ``hnsw_lite.build_hnsw_sharded``.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from repro_torch.index.hnsw_lite import ShardedHNSW, hnsw_frontier_search
from repro_torch.kernels.sdc.defaults import BLOCK_N, BLOCK_Q, plan_for
from repro_torch.kernels.sdc.ops import resolve_backend, sdc_search_backend


class LeafSharding:
    """Where one engine input lives: replicated on every leaf, or split
    along axis 0 into one contiguous row slice per leaf (the analogue of a
    ``NamedSharding`` with ``P()`` or ``P(shard_axes)``)."""

    def __init__(self, devices, *, replicated: bool):
        self.devices = list(devices)
        self.replicated = replicated

    def place(self, x) -> list:
        """``x`` as one tensor per leaf (the analogue of ``jax.device_put``).

        A list of per-leaf tensors is already placed and passes through. A
        tensor already on a leaf's device is not copied: replicated, every
        leaf on that device gets the tensor itself; sharded, a view of its
        rows. ``N % n_leaves != 0`` raises.
        """
        n = len(self.devices)
        if isinstance(x, (list, tuple)):
            if len(x) != n:
                raise ValueError(f"got {len(x)} per-leaf tensors for {n} leaves")
            return list(x)
        x = torch.as_tensor(x)
        if self.replicated:
            on = {}
            return [on.setdefault(d, x.to(d)) for d in self.devices]
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"cannot shard {rows} rows evenly over {n} leaves "
                             f"({rows} % {n} = {rows % n})")
        s = rows // n
        return [x[i * s:(i + 1) * s].to(d) for i, d in enumerate(self.devices)]


def gather_order(mesh, shard_axes=("data", "model")) -> list:
    """The leaf ranks in the order the reference's merge concatenates them.

    The reference gathers over each sharded axis in turn
    (``all_gather(..., tiled=True)``), so the first axis varies fastest in
    the result while the rank (``axis_index`` linearised) has it vary
    slowest.
    """
    sizes = [mesh.axis_size(ax) for ax in shard_axes]
    order = []
    for rev in itertools.product(*(range(s) for s in reversed(sizes))):
        rank = 0
        for size, i in zip(sizes, reversed(rev)):
            rank = rank * size + i
        order.append(rank)
    return order


def _leaf_backends(backend: str, devices) -> list:
    """The resolved backend of each leaf ("auto" follows its device)."""
    return [resolve_backend(backend, d) for d in devices]


def _leaf_scan(
    q_codes: torch.Tensor,
    shard_codes: torch.Tensor,
    shard_inv: torch.Tensor,
    shard_base: int,
    *,
    n_levels: int,
    k: int,
    backend: str = "auto",
    packed: bool = False,
    block_q: int = BLOCK_Q,
    block_n: int = BLOCK_N,
    block_plan=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local exhaustive SDC scan + top-k on one leaf.

    The kernel (one ``sdc_topk`` launch, at ``block_plan``'s geometry when
    given) on a card, the plain twin on the CPU; both treat ``shard_inv ==
    0`` entries as excluded (drained docs). Empty slots come back as -inf
    with id -1, live ids as global ids.
    """
    vals, idx = sdc_search_backend(
        q_codes, shard_codes, shard_inv, n_levels=n_levels, k=k, backend=backend,
        block_q=block_q, block_n=block_n, packed=packed, block_plan=block_plan,
    )
    return _globalize(vals, idx, shard_base)


def _globalize(vals, idx, shard_base: int):
    """Strict -inf for empty slots and global ids; the -1 empty-slot
    sentinel is never shifted into a neighbour shard's id range."""
    live = idx >= 0
    return (torch.where(live, vals, -torch.inf),
            torch.where(live, idx + shard_base, -1).to(torch.int32))


def _merge(parts, order, k: int, device, leaf_alive=None):
    """Selection merge: the leaves' [Q, k_leaf] lists (by rank) on
    ``device``, a dead leaf's scores set to -inf there (its ids kept; a
    0-d index of ``leaf_alive``, no host read), concatenated in ``order``,
    then the top-k by a stable descending sort (ties toward the earlier
    position, ``jax.lax.top_k``'s order)."""
    if leaf_alive is not None:
        leaf_alive = torch.as_tensor(leaf_alive, device=device)
    vals, ids = [], []
    for rank in order:
        v, i = (x.to(device) for x in parts[rank])
        if leaf_alive is not None:
            v = torch.where(leaf_alive[rank], v, -torch.inf)
        vals.append(v)
        ids.append(i)
    vals, pos = torch.sort(torch.cat(vals, 1), dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(torch.cat(ids, 1), 1, pos[:, :k])


def _make_search(mesh, *, n_levels, k, shard_axes, backend, packed, block_q, block_n,
                 block_plan, failover):
    """Common builder for the plain and failover engines."""
    if block_q < 1 or block_n < 1:
        raise ValueError(f"blocks must be >= 1, got ({block_q}, {block_n})")
    devices = mesh.leaf_devices(shard_axes)
    backends = _leaf_backends(backend, devices)
    order = gather_order(mesh, shard_axes)
    rep = LeafSharding(devices, replicated=True)
    shard = LeafSharding(devices, replicated=False)

    def search(q_codes, d_codes, d_inv, *rest):
        qs, cs, vs = rep.place(q_codes), shard.place(d_codes), shard.place(d_inv)
        parts = []
        for rank, (q, c, v, b) in enumerate(zip(qs, cs, vs, backends)):
            parts.append(_leaf_scan(q, c, v, rank * c.shape[0], n_levels=n_levels, k=k,
                                    backend=b, packed=packed, block_q=block_q,
                                    block_n=block_n, block_plan=block_plan))
        # A dead/drained leaf contributes -inf scores; the merge proceeds
        # from the survivors (paper §3.3.3 proxy timeout).
        leaf_alive = rest[0] if failover else None
        return _merge(parts, order, k, qs[0].device, leaf_alive)

    return search


def make_distributed_search(
    mesh,
    *,
    n_levels: int,
    k: int,
    shard_axes: Tuple[str, ...] = ("data", "model"),
    backend: str = "auto",
    packed: bool = False,
    block_q: int = BLOCK_Q,
    block_n: int = BLOCK_N,
    block_plan=None,
):
    """Build the global search fn over a ``LeafMesh``.

    Inputs: q_codes [Q, D] int8 (replicated), d_codes [N, D] int8 — or
    nibble-packed uint8 [N, D//2] with ``packed=True`` — and d_inv [N] f32,
    split on axis 0 over the leaves of ``shard_axes``; each a global tensor
    or the per-leaf list ``engine_input_shardings``' placements give.
    Output: (scores [Q, k], global ids [Q, k]) on the queries' device (leaf
    0's copy of them when they come per leaf).

    ``backend`` "auto" runs each leaf on its device's route (the kernel on
    a card, the plain twin on the CPU); "cuda" on a CPU leaf raises.
    ``block_plan`` (kind "scan", e.g. tuned at a leaf's rows by
    ``launch/autotune.py``) is every card leaf's ``sdc_topk`` launch
    geometry; inert on a CPU leaf. ``block_q``/``block_n`` are checked and
    change nothing. No plan changes a score or an id.
    """
    return _make_search(
        mesh, n_levels=n_levels, k=k, shard_axes=shard_axes, backend=backend,
        packed=packed, block_q=block_q, block_n=block_n,
        block_plan=plan_for(block_plan, "scan"), failover=False,
    )


def engine_input_shardings(mesh, shard_axes=("data", "model")):
    """Placements matching ``make_distributed_search``'s inputs: (queries
    replicated, codes sharded, inverse norms sharded)."""
    devices = mesh.leaf_devices(shard_axes)
    sh = LeafSharding(devices, replicated=False)
    return LeafSharding(devices, replicated=True), sh, sh


def make_failover_search(
    mesh,
    *,
    n_levels: int,
    k: int,
    shard_axes: Tuple[str, ...] = ("data", "model"),
    backend: str = "auto",
    packed: bool = False,
    block_q: int = BLOCK_Q,
    block_n: int = BLOCK_N,
    block_plan=None,
):
    """Distributed search with leaf failover (straggler/failure tolerance).

    Production leaves time out (paper §3.3.3's proxy drops late leaves and
    merges what arrived). The same contract is a ``leaf_alive`` input, a
    bool tensor [n_leaves] on the merge device: a dead/drained leaf
    contributes -inf scores (its ids stay, and surface only when the
    survivors give fewer than k finite results) and the merge proceeds
    from the survivors. The mask is applied on the device with no host
    read, and flipping it between calls needs no rebuild: recall drops by
    ~|dead|/|leaves| of the corpus, latency does not. ``block_plan`` as
    in ``make_distributed_search``.
    """
    return _make_search(
        mesh, n_levels=n_levels, k=k, shard_axes=shard_axes, backend=backend,
        packed=packed, block_q=block_q, block_n=block_n,
        block_plan=plan_for(block_plan, "scan"), failover=True,
    )


def make_hnsw_search(
    mesh,
    *,
    n_levels: int,
    k: int,
    ef: int = 64,
    beam: int = 8,
    max_hops: int = 64,
    shard_axes: Tuple[str, ...] = ("data", "model"),
    backend: str = "auto",
    packed: bool = False,
):
    """Distributed HNSW engine: batched-frontier graph search per leaf.

    Same proxy/leaf/merge skeleton as ``make_distributed_search``, but each
    leaf walks its local NSW graph (built by ``build_hnsw_sharded``) with
    ``hnsw_frontier_search`` instead of scanning its whole shard: one
    ``sdc_gather_topk`` a hop on a card, and one host read a hop for the
    early exit (``hnsw_frontier_search.host_reads``), leaf after leaf.

    Inputs (see ``hnsw_engine_shardings``): q_codes [Q, D] replicated;
    codes [N, D(/2)], inv_norm [N], nbr_codes [N, M, D(/2)], nbr_inv [N, M],
    nbr_ids [N, M] (leaf-local ids) and entries [n_leaves, E] (leaf-local
    ids) split on axis 0. Output: (scores [Q, k], global ids [Q, k]) on the
    queries' device.
    """
    devices = mesh.leaf_devices(shard_axes)
    backends = _leaf_backends(backend, devices)
    order = gather_order(mesh, shard_axes)
    rep = LeafSharding(devices, replicated=True)
    shard = LeafSharding(devices, replicated=False)
    ef_eff = max(ef, k)
    beam_eff = max(1, min(beam, ef_eff))

    def search(q_codes, codes, inv, nbr_codes, nbr_inv, nbr_ids, entries):
        qs = rep.place(q_codes)
        tables = [shard.place(t) for t in (codes, inv, nbr_codes, nbr_inv, nbr_ids, entries)]
        parts = []
        for rank, (q, c, v, nc, nv, ni, e) in enumerate(zip(qs, *tables)):
            # One graph per leaf: a build_hnsw_sharded(n_leaves=...) that
            # doesn't match the mesh would alias leaf-local neighbour ids
            # across sub-graphs and silently corrupt global ids.
            if e.shape[0] != 1:
                raise ValueError(
                    f"build_hnsw_sharded n_leaves must equal the mesh's "
                    f"sharded device count (each leaf got {e.shape[0]} "
                    "entry rows, expected 1)"
                )
            vals, ids, _ = hnsw_frontier_search(
                q, c, v, nc, nv, ni, e.reshape(-1), n_levels=n_levels, k=k, ef=ef_eff,
                beam=beam_eff, max_hops=max_hops, backend=backends[rank], packed=packed,
            )
            parts.append(_globalize(vals, ids, rank * c.shape[0]))
        return _merge(parts, order, k, qs[0].device)

    return search


def hnsw_engine_shardings(mesh, shard_axes=("data", "model")):
    """Placements for ``make_hnsw_search``'s seven inputs (queries
    replicated, every table sharded on axis 0)."""
    rep, sh, _ = engine_input_shardings(mesh, shard_axes)
    return (rep,) + (sh,) * 6


def hnsw_engine_inputs(index: ShardedHNSW):
    """The sharded input tensors of ``make_hnsw_search``, in order."""
    return (
        index.codes, index.inv_norm, index.nbr_codes, index.nbr_inv,
        index.nbr_ids, index.entries,
    )


# ---------------------------------------------------------------------------
# Rebuild-from-snapshot entry points (live index lifecycle): "here is a
# corpus snapshot, give me a serving SearchFn over this replica's leaves".
# Each wraps the engine's construction and the placement of its inputs
# into one closure, placed once and reused by every call.
# ---------------------------------------------------------------------------


def flat_engine_inputs_from_snapshot(
    codes,
    n_levels: int,
    *,
    packed: bool = False,
    coarse_levels: int = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared flat-engine inputs on ``device`` from a snapshot's unpacked
    codes: (codes [nibble-packed when ``packed``], inverse doc norms).

    Replica-independent, so a rolling swap computes them once per snapshot
    and places them on every replica's leaves (``launch/lifecycle.
    EngineBuilder``); replicas on ``device`` share them. With
    ``coarse_levels`` they are the hot coarse tier of a bi-granular
    engine: level-prefix codes and their inverse norms at
    ``coarse_levels`` levels.
    """
    from repro_torch.core.binarize_lib import coarse_codes, pack_codes_nibbles
    from repro_torch.device import resolve_device
    from repro_torch.index.flat import device_codes
    from repro_torch.kernels.sdc import ref as sdc_ref

    codes = device_codes(codes, resolve_device(device))
    if coarse_levels is not None:
        codes = coarse_codes(codes, n_levels, coarse_levels)
        n_levels = coarse_levels
    inv = sdc_ref.doc_inv_norms(codes, n_levels)
    if packed:
        codes = pack_codes_nibbles(codes)
    return codes, inv


def engine_search_from_snapshot(
    mesh,
    codes,
    n_levels: int = None,
    *,
    k: int,
    shard_axes: Tuple[str, ...] = ("data", "model"),
    backend: str = "auto",
    packed: bool = False,
    block_q: int = BLOCK_Q,
    block_n: int = BLOCK_N,
    prepared: Tuple[torch.Tensor, torch.Tensor] = None,
    rerank: dict | None = None,
    effort=None,
    block_plan=None,
):
    """Fresh flat engine over ``mesh`` from a snapshot's unpacked codes.

    Shards the codes (nibble-packing them first when ``packed``) and
    inverse norms over the mesh's leaves and returns ``q_codes -> (scores,
    ids)``: the queries move to leaf 0's device inside the closure, where
    the merge runs, so it is a drop-in serving ``SearchFn``. Pass
    ``prepared`` (from ``flat_engine_inputs_from_snapshot``) to skip the
    per-replica recompute; without it the inputs are computed on leaf 0's
    device. ``fn.leaf_inputs`` holds the placed per-leaf (codes, inverse
    norms).

    ``codes`` may be a ``CorpusSnapshot`` (carries its own ``n_levels``)
    or raw unpacked codes plus an explicit ``n_levels``.

    ``rerank={"coarse_levels": c, "k_coarse": k'}`` switches to
    bi-granular mode: the leaves scan the level-prefix codes at ``c``
    levels (packed only when ``c <= 4``), the merge gives the global coarse
    top-k' survivors (k' clamped to the global N), and they are reranked
    *post-merge* on the full-level codes in one gather call (a numpy /
    memmapped snapshot stays in host memory, only survivor rows are read).
    ``prepared`` must then come from ``flat_engine_inputs_from_snapshot(...,
    coarse_levels=c)``. The closure carries ``fn.reranked = True``.
    ``effort`` (int ``level`` attribute, 0 = full) narrows the rerank to
    the merged top-k' list's top-``k_coarse >> level`` prefix (floored at
    k, ``split_effort``).

    ``block_plan`` (a ``BlockPlan`` or ``{kind: plan}`` mapping) reaches
    the leaves' scans (kind "scan": a card leaf's launch geometry) and, in
    bi-granular mode, the rerank's group size (kind "rerank"). Plans never
    change scores.
    """
    from repro_torch.index._snapshot import (
        resolve_rerank_args,
        resolve_snapshot_args,
        split_effort,
    )

    codes, n_levels = resolve_snapshot_args(codes, n_levels)
    rr = resolve_rerank_args(rerank, n_levels)
    scan_plan = plan_for(block_plan, "scan")
    rerank_plan = plan_for(block_plan, "rerank")
    qspec, *in_specs = engine_input_shardings(mesh, shard_axes)
    dev0 = qspec.devices[0]
    if rr is None:
        if prepared is None:
            prepared = flat_engine_inputs_from_snapshot(codes, n_levels, packed=packed,
                                                        device=dev0)
        search = make_distributed_search(
            mesh, n_levels=n_levels, k=k, shard_axes=shard_axes, backend=backend,
            packed=packed, block_q=block_q, block_n=block_n, block_plan=scan_plan,
        )
        ins = [s.place(a) for a, s in zip(prepared, in_specs)]

        def snapshot_search(q_codes):
            q = torch.as_tensor(q_codes).to(dev0, torch.int8).contiguous()
            return search(qspec.place(q), *ins)

        snapshot_search.leaf_inputs = ins
        return snapshot_search

    from repro_torch.core.binarize_lib import coarse_codes
    from repro_torch.index.flat import device_codes
    from repro_torch.kernels.sdc.rerank import fine_inv_norms, sdc_rerank_backend

    c_levels, k_coarse = rr
    k_coarse = min(k_coarse, codes.shape[0])
    packed_c = packed and c_levels <= 4
    if prepared is None:
        prepared = flat_engine_inputs_from_snapshot(
            codes, n_levels, packed=packed_c, coarse_levels=c_levels, device=dev0,
        )
    search = make_distributed_search(
        mesh, n_levels=c_levels, k=k_coarse, shard_axes=shard_axes, backend=backend,
        packed=packed_c, block_q=block_q, block_n=block_n, block_plan=scan_plan,
    )
    ins = [s.place(a) for a, s in zip(prepared, in_specs)]
    fine_codes = codes if isinstance(codes, np.ndarray) else device_codes(codes, dev0)
    fine_inv = fine_inv_norms(fine_codes, n_levels, device=dev0)

    def snapshot_search(q_codes):
        q = torch.as_tensor(q_codes).to(dev0, torch.int8).contiguous()
        qc = coarse_codes(q, n_levels, c_levels)
        _, cand = search(qspec.place(qc), *ins)
        if effort is not None:
            kc_eff, _ = split_effort(effort.level, k=k, k_coarse=k_coarse)
            cand = cand[:, :kc_eff]
        return sdc_rerank_backend(
            q, fine_codes, fine_inv, cand, n_levels=n_levels, k=k,
            backend=backend, block_plan=rerank_plan,
        )

    if effort is not None:
        snapshot_search.effort = effort
    snapshot_search.reranked = True
    snapshot_search.leaf_inputs = ins
    return snapshot_search


def sharded_graph_from_snapshot(
    codes,
    n_levels: int,
    *,
    n_leaves: int,
    M: int = 16,
    ef_construction: int = 64,
    seed: int = 0,
    packed: bool = False,
    device="cuda",
) -> ShardedHNSW:
    """Per-leaf NSW graphs from a snapshot's unpacked codes, built on the
    host, their tables stacked on ``device``: the single copy of the
    inverse-norm + ``build_hnsw_sharded`` recipe, shared by
    ``hnsw_engine_search_from_snapshot`` and the lifecycle
    ``EngineBuilder``'s per-digest cache (any drift between two copies
    would silently break the swap's bit-identity guarantee)."""
    from repro_torch.device import resolve_device
    from repro_torch.index.hnsw_lite import build_hnsw_sharded
    from repro_torch.kernels.sdc.rerank import fine_inv_norms

    dev = resolve_device(device)
    host = codes.cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes)
    inv = fine_inv_norms(host, n_levels, device=dev)
    return build_hnsw_sharded(
        host, inv, n_leaves=n_leaves, n_levels=n_levels, M=M,
        ef_construction=ef_construction, seed=seed, packed=packed, device=dev,
    )


def hnsw_engine_search_from_snapshot(
    mesh,
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
    shard_axes: Tuple[str, ...] = ("data", "model"),
    backend: str = "auto",
    packed: bool = False,
    sharded: ShardedHNSW = None,
    block_plan=None,
):
    """Fresh HNSW engine over ``mesh`` from a snapshot's unpacked codes.

    Rebuilds one NSW graph per leaf (``sharded_graph_from_snapshot``,
    deterministic for the same snapshot + seed; its tables on leaf 0's
    device) unless a prebuilt ``sharded`` graph is passed: replicas share
    the leaf layout, so a rolling swap builds the graph once and reuses it
    for every replica's placement (see ``launch/lifecycle.EngineBuilder``).
    ``fn.leaf_inputs`` holds the placed per-leaf tables.

    ``codes`` may be a ``CorpusSnapshot`` or raw unpacked codes plus an
    explicit ``n_levels``. ``block_plan`` is accepted for signature parity
    and inert: the walk's gather geometry is fixed by the beam and
    neighbourhood layout (kind "gather"). A mapping is checked all the
    same.
    """
    plan_for(block_plan, "gather")  # validate mapping keys early
    from repro_torch.index._snapshot import resolve_snapshot_args

    codes, n_levels = resolve_snapshot_args(codes, n_levels)
    qspec, *in_specs = hnsw_engine_shardings(mesh, shard_axes)
    dev0 = qspec.devices[0]
    n_leaves = len(qspec.devices)
    if sharded is None:
        sharded = sharded_graph_from_snapshot(
            codes, n_levels, n_leaves=n_leaves, M=M, ef_construction=ef_construction,
            seed=seed, packed=packed, device=dev0,
        )
    if sharded.entries.shape[0] != n_leaves:
        raise ValueError(
            f"prebuilt sharded graph has {sharded.entries.shape[0]} leaves, "
            f"mesh wants {n_leaves}"
        )
    search = make_hnsw_search(
        mesh, n_levels=n_levels, k=k, ef=ef, beam=beam, max_hops=max_hops,
        shard_axes=shard_axes, backend=backend, packed=packed,
    )
    ins = [s.place(a) for a, s in zip(hnsw_engine_inputs(sharded), in_specs)]

    def snapshot_search(q_codes):
        q = torch.as_tensor(q_codes).to(dev0, torch.int8).contiguous()
        return search(qspec.place(q), *ins)

    snapshot_search.leaf_inputs = ins
    return snapshot_search
