"""Live index lifecycle, the builder half (ports ``CorpusSnapshot``,
``IndexVersion``, the index builders and their registry from
``repro/launch/lifecycle.py``).

  * ``CorpusSnapshot`` — an immutable corpus capture (unpacked codes +
    level count + embedding-version tag) with a content ``digest``, the
    unit the offline indexing pipeline hands to the serving tier.
  * ``IndexVersion`` — what a replica serves: corpus digest +
    embedding-version tag + index kind + build params. Two replicas with
    equal ``IndexVersion``s are bit-identical by construction (every
    builder is deterministic in its params).
  * ``IndexBuilder`` protocol — ``build(snapshot, replica=i) -> SearchFn``;
    one protocol fronts every index family through the
    rebuild-from-snapshot entry points (``flat.flat_search_from_snapshot``,
    ``ivf.ivf_search_from_snapshot``, ``hnsw_lite.hnsw_search_from_snapshot``,
    ``engine.*_search_from_snapshot`` for replicas on their own leaves).

The digest and the ``IndexVersion`` equal the reference's for the same
codes and build arguments, so a tag means the same corpus and index in
both packages. The builders take a ``device`` (``"cuda"`` by default,
raising without a card), which stays out of ``params`` and so out of the
version: where an index lives does not change its results. The rolling
swap, the canary revival and the router this module fronts in the
reference come with the serving tier.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
from typing import Any, Dict, List, Protocol, Tuple

import numpy as np
import torch

from repro_torch.launch.serving import SearchFn


def _host_codes(codes) -> np.ndarray:
    """Codes as a contiguous numpy array: a tensor (a CUDA one too) as its
    host copy, so its digest hashes the numpy dtype name ("int8", not
    "torch.int8")."""
    if isinstance(codes, torch.Tensor):
        codes = codes.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(codes))


# ---------------------------------------------------------------------------
# snapshots + versions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class CorpusSnapshot:
    """One immutable corpus capture handed to the serving tier.

    ``codes`` are the UNPACKED recurrent-binary codes ([N, D] int8) of
    the whole corpus under one embedding version — builders derive
    everything else (inverse norms, nibble packing, cluster/graph
    structure) deterministically from here. Equality/hash go through the
    content ``digest``, so "same digest == same corpus" holds for ``==``
    and dict keys too.
    """

    codes: Any  # [N, D] int8: numpy, a tensor on any device, or np.memmap for cold tiers
    n_levels: int
    embedding_version: str = "v0"

    def __eq__(self, other) -> bool:
        return (isinstance(other, CorpusSnapshot)
                and self.n_levels == other.n_levels
                and self.embedding_version == other.embedding_version
                and self.digest == other.digest)

    def __hash__(self) -> int:
        return hash((self.digest, self.n_levels, self.embedding_version))

    def spilled(self, path) -> "CorpusSnapshot":
        """A content-equal snapshot whose codes live in a read-only
        ``np.memmap`` at ``path``.

        The cold-tier handoff for bi-granular serving: builders keep numpy
        fine codes in host memory and read only the per-query survivor
        rows, so the full-level tier may exceed RAM while the coarse tier
        stays on the card. Same bytes, same ``digest``.
        """
        arr = _host_codes(self.codes)
        mm = np.memmap(path, dtype=arr.dtype, mode="w+", shape=arr.shape)
        mm[:] = arr
        mm.flush()
        ro = np.memmap(path, dtype=arr.dtype, mode="r", shape=arr.shape)
        return CorpusSnapshot(codes=ro, n_levels=self.n_levels,
                              embedding_version=self.embedding_version)

    @functools.cached_property
    def digest(self) -> str:
        """Content hash of the codes (shape, numpy dtype name, bytes): the
        corpus half of an ``IndexVersion``. Cached — the snapshot is
        immutable, so one hash is the right number (cached_property
        bypasses the frozen-dataclass setattr)."""
        arr = _host_codes(self.codes)
        h = hashlib.sha1()
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
        return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class IndexVersion:
    """What a replica serves: corpus digest + embedding version + build
    params. Hashable and comparable."""

    corpus_digest: str
    embedding_version: str
    index_kind: str
    build_params: Tuple[Tuple[str, Any], ...]

    @property
    def tag(self) -> str:
        return (f"{self.index_kind}:{self.embedding_version}"
                f":{self.corpus_digest[:12]}")


# ---------------------------------------------------------------------------
# index builders (one protocol, every index family)
# ---------------------------------------------------------------------------


class IndexBuilder(Protocol):
    """Rebuild a serving ``SearchFn`` from a corpus snapshot.

    ``replica`` lets placement-aware builders (the distributed engine, one
    ``LeafMesh`` per replica) target the replica being built; single-host
    builders ignore it. Builders must be deterministic in (snapshot,
    params).
    """

    kind: str
    params: Dict[str, Any]

    def build(self, snapshot: CorpusSnapshot, *,
              replica: int = 0) -> SearchFn: ...


def builder_version(builder: "IndexBuilder",
                    snapshot: CorpusSnapshot) -> IndexVersion:
    """The ``IndexVersion`` that ``builder.build(snapshot)`` serves."""
    return IndexVersion(
        corpus_digest=snapshot.digest,
        embedding_version=snapshot.embedding_version,
        index_kind=builder.kind,
        build_params=tuple(sorted(
            (k, v) for k, v in builder.params.items()
            if isinstance(v, (int, float, str, bool, type(None)))
        )),
    )


def _rerank_params(coarse_levels, k_coarse):
    """Validate a builder's scalar bi-granular knobs; dict-or-None.

    Builders take the two scalars (not the ``rerank={...}`` dict) so the
    knobs flow through ``builder_version``'s scalar filter: a tiered and a
    single-tier build of the same snapshot are never version-equivalent.
    Range checks against ``n_levels`` happen in the entry points; here
    only the pairing is enforced, at construction time.
    """
    if (coarse_levels is None) != (k_coarse is None):
        raise ValueError(
            "coarse_levels and k_coarse must be set together "
            f"(got coarse_levels={coarse_levels}, k_coarse={k_coarse})"
        )
    if coarse_levels is None:
        return None
    return {"coarse_levels": int(coarse_levels), "k_coarse": int(k_coarse)}


class _SnapshotCachingBuilder:
    """Digest-keyed one-entry build cache shared by the single-host
    builders: replicas on one host share index tensors, so a rolling swap
    over N replicas rebuilds the identical index once. Subclasses
    implement ``_build(snapshot)``; ``device`` is where the index lives."""

    def __init__(self, device):
        self.device = device
        self._cache: Dict[str, SearchFn] = {}

    def build(self, snapshot: CorpusSnapshot, *, replica: int = 0) -> SearchFn:
        key = snapshot.digest
        if key not in self._cache:
            self._cache.clear()  # hold at most one snapshot's index
            self._cache[key] = self._build(snapshot)
        return self._cache[key]

    def _entry_params(self) -> Dict[str, Any]:
        """``params`` as the entry point takes them (the bi-granular
        scalars become its ``rerank`` dict)."""
        return {k: v for k, v in self.params.items() if k not in ("coarse_levels", "k_coarse")}


class FlatBuilder(_SnapshotCachingBuilder):
    """Exhaustive flat index (``flat.flat_search_from_snapshot``).

    ``coarse_levels``/``k_coarse`` (set together) switch the build to
    bi-granular mode. ``block_plan`` (a ``BlockPlan`` or ``{kind: plan}``
    mapping) never changes scores and, being non-scalar, stays out of
    ``builder_version``. ``backend`` takes the port's names ("auto",
    "cuda", "torch"); its default "auto" runs the kernels on a card.
    """

    kind = "flat"

    def __init__(self, *, k: int = 10, packed: bool = False,
                 backend: str = "auto", block_n: int = 512,
                 coarse_levels: int = None, k_coarse: int = None,
                 block_plan=None, device="cuda"):
        super().__init__(device)
        self._rerank = _rerank_params(coarse_levels, k_coarse)
        self.params = dict(k=k, packed=packed, backend=backend,
                           block_n=block_n, coarse_levels=coarse_levels,
                           k_coarse=k_coarse, block_plan=block_plan)

    def _build(self, snapshot: CorpusSnapshot) -> SearchFn:
        from repro_torch.index.flat import flat_search_from_snapshot

        return flat_search_from_snapshot(snapshot, rerank=self._rerank, device=self.device,
                                         **self._entry_params())


class IVFBuilder(_SnapshotCachingBuilder):
    """IVF index, re-clustered per snapshot (``ivf_search_from_snapshot``).

    ``probe_budget`` switches the served closure to occupancy-weighted
    probe allocation; it is a scalar, so a budgeted and a flat-nprobe
    build are never version-equivalent. The k-means draws come from a
    torch generator seeded with ``seed``.
    """

    kind = "ivf"

    def __init__(self, *, k: int = 10, nlist: int = 64, nprobe: int = 32,
                 seed: int = 0, kmeans_iters: int = 20,
                 packed: bool = False, backend: str = "auto",
                 coarse_levels: int = None, k_coarse: int = None,
                 probe_budget: int = None, block_plan=None, device="cuda"):
        super().__init__(device)
        self._rerank = _rerank_params(coarse_levels, k_coarse)
        self.params = dict(k=k, nlist=nlist, nprobe=nprobe, seed=seed,
                           kmeans_iters=kmeans_iters, packed=packed,
                           backend=backend, coarse_levels=coarse_levels,
                           k_coarse=k_coarse, probe_budget=probe_budget,
                           block_plan=block_plan)

    def _build(self, snapshot: CorpusSnapshot) -> SearchFn:
        from repro_torch.index.ivf import ivf_search_from_snapshot

        return ivf_search_from_snapshot(snapshot, rerank=self._rerank, device=self.device,
                                        **self._entry_params())


class HNSWBuilder(_SnapshotCachingBuilder):
    """NSW graph, rebuilt per snapshot (``hnsw_search_from_snapshot``).

    The host-side graph build is O(N^2), which makes the digest cache
    matter most here."""

    kind = "hnsw"

    def __init__(self, *, k: int = 10, M: int = 16,
                 ef_construction: int = 64, ef: int = 64, beam: int = 8,
                 max_hops: int = 64, seed: int = 0, packed: bool = False,
                 backend: str = "auto",
                 coarse_levels: int = None, k_coarse: int = None,
                 block_plan=None, device="cuda"):
        super().__init__(device)
        self._rerank = _rerank_params(coarse_levels, k_coarse)
        self.params = dict(k=k, M=M, ef_construction=ef_construction,
                           ef=ef, beam=beam, max_hops=max_hops, seed=seed,
                           packed=packed, backend=backend,
                           coarse_levels=coarse_levels, k_coarse=k_coarse,
                           block_plan=block_plan)

    def _build(self, snapshot: CorpusSnapshot) -> SearchFn:
        from repro_torch.index.hnsw_lite import hnsw_search_from_snapshot

        return hnsw_search_from_snapshot(snapshot, rerank=self._rerank, device=self.device,
                                         **self._entry_params())


class EngineBuilder:
    """Distributed engine replicas, one ``LeafMesh`` per replica.

    ``meshes[i]`` is replica i's leaves (``mesh.make_replica_meshes``);
    ``build`` shards the snapshot over THAT replica's leaves and returns
    the engine closed over its placed inputs. ``index`` picks the leaf
    algorithm: "flat" (exhaustive leaf scan) or "hnsw" (batched-frontier
    graph per leaf). The inputs every replica shares (the flat engine's
    packed codes + inverse norms, the per-leaf NSW graphs) are made once
    per snapshot digest, on the first leaf of the first replica built, and
    cached; a replica's placement copies them only to leaves on another
    device, so replicas that share a card share the leaf tensors.
    """

    def __init__(self, meshes: List[Any], *, index: str = "flat",
                 n_levels: int, k: int = 10, backend: str = "auto",
                 packed: bool = False, shard_axes=("data", "model"),
                 M: int = 16, ef_construction: int = 48, ef: int = 64,
                 beam: int = 16, max_hops: int = 64, seed: int = 0,
                 coarse_levels: int = None, k_coarse: int = None,
                 block_plan=None):
        if index not in ("flat", "hnsw"):
            raise ValueError(f"EngineBuilder index must be flat|hnsw, "
                             f"got {index!r}")
        self._rerank = _rerank_params(coarse_levels, k_coarse)
        if self._rerank is not None and index != "flat":
            raise ValueError(
                "bi-granular rerank is only supported for the flat "
                "engine (per-leaf coarse scan + post-merge fine rerank); "
                f"got index={index!r}"
            )
        self.meshes = list(meshes)
        self.kind = f"engine-{index}"
        self.index = index
        self.params = dict(n_levels=n_levels, k=k, backend=backend,
                           packed=packed, M=M,
                           ef_construction=ef_construction, ef=ef,
                           beam=beam, max_hops=max_hops, seed=seed,
                           coarse_levels=coarse_levels, k_coarse=k_coarse)
        self.block_plan = block_plan
        self.shard_axes = tuple(shard_axes)
        # Digest-keyed artifacts shared by every replica: the per-leaf NSW
        # graphs (hnsw) / packed codes + inv norms (flat).
        self._graph_cache: Dict[str, Any] = {}
        self._flat_cache: Dict[str, Any] = {}

    def _sharded_graph(self, snapshot: CorpusSnapshot, n_leaves: int, device):
        from repro_torch.index.engine import sharded_graph_from_snapshot

        key = f"{snapshot.digest}:{n_leaves}"
        if key not in self._graph_cache:
            self._graph_cache.clear()
            self._graph_cache[key] = sharded_graph_from_snapshot(
                snapshot.codes, snapshot.n_levels, n_leaves=n_leaves,
                M=self.params["M"],
                ef_construction=self.params["ef_construction"],
                seed=self.params["seed"], packed=self.params["packed"],
                device=device,
            )
        return self._graph_cache[key]

    def _flat_inputs(self, snapshot: CorpusSnapshot, device):
        from repro_torch.index.engine import flat_engine_inputs_from_snapshot

        c = self._rerank["coarse_levels"] if self._rerank else None
        packed = self.params["packed"] and (c is None or c <= 4)
        key = f"{snapshot.digest}:{c}"
        if key not in self._flat_cache:
            self._flat_cache.clear()
            self._flat_cache[key] = flat_engine_inputs_from_snapshot(
                snapshot.codes, snapshot.n_levels,
                packed=packed, coarse_levels=c, device=device,
            )
        return self._flat_cache[key]

    def build(self, snapshot: CorpusSnapshot, *, replica: int = 0) -> SearchFn:
        from repro_torch.index import engine

        mesh = self.meshes[replica]
        leaves = mesh.leaf_devices(self.shard_axes)
        p = self.params
        if self.index == "flat":
            return engine.engine_search_from_snapshot(
                mesh, snapshot, k=p["k"],
                shard_axes=self.shard_axes, backend=p["backend"],
                packed=p["packed"], prepared=self._flat_inputs(snapshot, leaves[0]),
                rerank=self._rerank, block_plan=self.block_plan,
            )
        return engine.hnsw_engine_search_from_snapshot(
            mesh, snapshot, k=p["k"],
            ef=p["ef"], beam=p["beam"], max_hops=p["max_hops"],
            shard_axes=self.shard_axes, backend=p["backend"],
            packed=p["packed"],
            sharded=self._sharded_graph(snapshot, len(leaves), leaves[0]),
        )


#: Single-host builder registry (the engine builder needs meshes and is
#: constructed explicitly).
INDEX_BUILDERS = {
    FlatBuilder.kind: FlatBuilder,
    IVFBuilder.kind: IVFBuilder,
    HNSWBuilder.kind: HNSWBuilder,
}


class UnknownBuildParam(TypeError):
    """``make_builder`` was handed a kwarg its builder does not take.

    Raised at the registry boundary, naming the builder and its real
    parameters, instead of the bare ``TypeError`` the constructor would
    throw deep in the stack."""


def make_builder(kind: str, *, device="cuda", **params) -> IndexBuilder:
    """Construct a single-host builder on ``device`` from the registry,
    kwargs checked.

    Unknown kwargs raise ``UnknownBuildParam`` listing the builder's
    accepted build parameters (``device`` is not one: it places the index
    and changes no result).
    """
    try:
        cls = INDEX_BUILDERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown index builder {kind!r}; known: {sorted(INDEX_BUILDERS)}"
        ) from None
    known = [p for p in inspect.signature(cls.__init__).parameters
             if p not in ("self", "device")]
    unknown = sorted(set(params) - set(known))
    if unknown:
        raise UnknownBuildParam(
            f"{cls.__name__} does not take {unknown} "
            f"(accepted: {sorted(known)})"
        )
    return cls(device=device, **params)
