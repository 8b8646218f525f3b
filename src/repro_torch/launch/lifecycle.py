"""Live index lifecycle (ports ``repro/launch/lifecycle.py`` whole:
``CorpusSnapshot``, ``IndexVersion``, the index builders and their
registry, and the rolling swap).

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
  * ``RollingSwapController`` — re-indexes a live tier one replica at a
    time: drain (the router stops routing there; in-flight tickets
    finish or re-dispatch through the existing failover path), quiesce
    the pipeline, rebuild from the snapshot, warm the fresh closure
    (``serving.warmup_replicas``), hot-swap it in, bump the stats
    generation, and canary-probe the replica back into rotation.
    ``run_stream_with_swap`` drives a query stream through the tier and
    kicks the swap mid-stream.

The digest and the ``IndexVersion`` equal the reference's for the same
codes and build arguments, so a tag means the same corpus and index in
both packages. The builders take a ``device`` (``"cuda"`` by default,
raising without a card when they build), which stays out of ``params``
and so out of the version: where an index lives does not change its
results. A swap's rebuilt index is a second copy of the corpus on the
device until the last reference to the old one is dropped.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch.launch import serving
from repro_torch.launch.proxy import AllReplicasDown, IncompatibleVersion, QueryRouter
from repro_torch.launch.serving import (
    DeadlineExpired,
    EncodeFn,
    RequestShed,
    SearchFn,
)

#: Minimum acceptable recall@k for cross-version traffic served through a
#: bc-trained compat encoder (the serving-tier face of the offline recall
#: floor of compatible training). The reference's upgrade bench row
#: records it and its bench gate enforces per-version recall >= floor
#: throughout a live migration.
COMPAT_RECALL_FLOOR = 0.55


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
    mapping, e.g. from ``launch/autotune``: on the card a scan plan is
    ``sdc_topk``'s launch geometry, a rerank plan the host gather's
    group) never changes scores and, being non-scalar, stays out of
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
    build are never version-equivalent. The k-means draws come from
    ``prng.key(seed)``, the reference's ``PRNGKey(seed)`` stream.
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
    ``block_plan`` reaches the flat engine: a scan plan (tuned at a leaf's
    rows) is every card leaf's ``sdc_topk`` geometry, a rerank plan the
    bi-granular rerank's group; the HNSW engine takes none.
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


# ---------------------------------------------------------------------------
# rolling swap controller
# ---------------------------------------------------------------------------


class SwapFailed(RuntimeError):
    """A replica's post-rebuild canary probe failed; the replica is left
    ``unhealthy`` (the periodic re-probe may still revive it) and the
    rolling swap stops before touching the next replica."""


@dataclasses.dataclass
class SwapReport:
    """What a rolling swap did, per replica (timings in seconds)."""

    version: IndexVersion
    replicas: List[dict] = dataclasses.field(default_factory=list)
    total_s: float = 0.0

    @property
    def swapped(self) -> int:
        return len(self.replicas)


class RollingSwapController:
    """Re-index a live ``QueryRouter`` tier one replica at a time.

    Per replica: drain -> quiesce -> rebuild (``builder.build``) -> warm
    (``serving.warmup_replicas``) -> hot-swap + new stats generation ->
    canary probe -> back in rotation. Traffic keeps flowing to the
    survivors throughout; with a single-replica tier the router sheds
    (retryable ``RequestShed``) for the rebuild window instead.

    ``encode_fn``: the encode stage for the NEW embedding version; None
    keeps each replica's current encode (a corpus-only refresh).
    ``canary``: the health-probe batch (defaults to ``warm_batches[0]``).
    """

    def __init__(
        self,
        router: QueryRouter,
        builder: IndexBuilder,
        *,
        warm_batches: Optional[List[Any]] = None,
        canary: Any = None,
        encode_fn: Optional[EncodeFn] = None,
        drain_timeout: float = 30.0,
        quiesce_timeout: float = 30.0,
        probe_timeout: float = 60.0,
        on_event: Optional[Callable[[str], None]] = None,
    ):
        if canary is None and not warm_batches:
            raise ValueError("need a canary batch (or warm_batches)")
        self.router = router
        self.builder = builder
        self.warm_batches = warm_batches
        self.canary = canary if canary is not None else warm_batches[0]
        self.encode_fn = encode_fn
        self.drain_timeout = drain_timeout
        self.quiesce_timeout = quiesce_timeout
        self.probe_timeout = probe_timeout
        self._log = on_event or (lambda msg: None)

    def _claim(self, replica: int) -> None:
        """Move ``replica`` into 'rebuilding' from whatever lifecycle
        state it is in: drain it when healthy, claim it directly when
        dead (the swap then doubles as its revival — nothing is routed
        there), and wait out an in-flight canary probe (the background
        probe loop and the swap race over unhealthy replicas). Once
        'rebuilding', the probe loop cannot touch the replica, so the
        hand-off is atomic."""
        router = self.router
        deadline = time.perf_counter() + self.drain_timeout
        while True:
            st = router.states()[replica]
            try:
                if st == "rebuilding":
                    raise SwapFailed(
                        f"replica {replica} is already rebuilding "
                        "(another controller owns it)"
                    )
                if st == "probing":
                    # The probe resolves to healthy or unhealthy shortly:
                    # condition-wait on the state machine (woken by the
                    # transition itself) instead of sleep-polling.
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or not router.wait_state(
                        replica, ("healthy", "unhealthy"),
                        timeout=remaining,
                    ):
                        raise SwapFailed(
                            f"replica {replica} still probing after "
                            f"{self.drain_timeout}s"
                        )
                    continue
                if st == "healthy":
                    router.drain(replica, timeout=self.drain_timeout)
                router.begin_rebuild(replica)  # draining|unhealthy
                return
            except ValueError:
                # state changed under us (a probe revived/parked the
                # replica between the read and the transition): re-read
                if time.perf_counter() >= deadline:
                    raise SwapFailed(
                        f"replica {replica} lifecycle state kept "
                        "changing; could not claim it for rebuild"
                    ) from None
                continue

    def swap_replica(self, replica: int, snapshot: CorpusSnapshot) -> dict:
        """Swap one replica to ``snapshot``; returns its report row."""
        router, log = self.router, self._log
        pipe = router.replicas.pipelines[replica]
        version = builder_version(self.builder, snapshot)

        t0 = time.perf_counter()
        log(f"replica {replica}: draining")
        self._claim(replica)  # ends with the replica in 'rebuilding'
        try:
            if not pipe.quiesce(timeout=self.quiesce_timeout):
                # Proxy tickets are gone (drained/re-dispatched) but an
                # inner batch is stuck on the pipeline; swapping under it
                # would race the scan stage.
                raise SwapFailed(
                    f"replica {replica} pipeline did not quiesce within "
                    f"{self.quiesce_timeout}s"
                )
            t_drain = time.perf_counter()

            log(f"replica {replica}: rebuilding ({version.tag})")
            search_fn = self.builder.build(snapshot, replica=replica)
            t_build = time.perf_counter()

            encode_fn = self.encode_fn or pipe.encode_fn
            if self.warm_batches:
                # Throwaway-pipeline warmup: worker threads carry
                # per-thread library state (set up on first use), so
                # warming on this thread alone is not enough.
                serving.warmup_replicas([(encode_fn, search_fn)],
                                        self.warm_batches)
            t_warm = time.perf_counter()

            pipe.swap_fns(encode_fn=encode_fn, search_fn=search_fn)
            generation = pipe.new_generation()
            router.set_version(replica, version)
        except BaseException as e:
            # An aborted swap must not strand the replica in a transient
            # state no probe targets (draining/rebuilding would be
            # one-strike-forever all over again) — park it unhealthy so
            # the canary re-probe can reclaim it once the cause clears.
            router.mark_unhealthy(replica, e)
            raise

        log(f"replica {replica}: probing")
        if not router.probe(replica, self.canary, timeout=self.probe_timeout,
                            from_rebuild=True):
            raise SwapFailed(
                f"replica {replica} failed its post-swap canary probe "
                f"(left unhealthy; version {version.tag})"
            )
        t_end = time.perf_counter()
        log(f"replica {replica}: healthy (generation {generation})")
        return {
            "replica": replica,
            "version": version.tag,
            "generation": generation,
            "drain_s": t_drain - t0,
            "build_s": t_build - t_drain,
            "warm_s": t_warm - t_build,
            "probe_s": t_end - t_warm,
            "total_s": t_end - t0,
        }

    def swap_all(self, snapshot: CorpusSnapshot) -> SwapReport:
        """Rolling swap of every replica, one at a time, under traffic."""
        report = SwapReport(version=builder_version(self.builder, snapshot))
        t0 = time.perf_counter()
        for replica in range(len(self.router.replicas)):
            report.replicas.append(self.swap_replica(replica, snapshot))
        report.total_s = time.perf_counter() - t0
        return report


def run_stream_with_swap(
    router: QueryRouter,
    stream: List[Any],
    *,
    controller: Optional[RollingSwapController] = None,
    snapshot: Optional[CorpusSnapshot] = None,
    swap_after: int = 0,
    shed_retry_s: float = 1e-3,
    deadline_s: Optional[float] = None,
) -> Tuple[List[Any], Optional[SwapReport]]:
    """Drive a query stream through the tier, optionally swapping mid-way.

    The shared driver loop of ``launch/serve.py`` and the serve
    drivers: submits every batch (retrying retryable
    ``RequestShed`` — a burst, or a swap/probe holding the tier for an
    instant), kicks ``controller.swap_all(snapshot)`` on a helper thread
    after ``swap_after`` submissions, awaits every ticket in submission
    order, and re-raises a failed swap only after the stream has
    resolved. A failed swap that downs the tier mid-stream surfaces the
    swap's own error (the root cause), not the ``AllReplicasDown`` /
    ticket errors it triggered. Returns ``(results, SwapReport | None)``.

    ``deadline_s`` gives every batch a per-query deadline that many
    seconds after its first submit attempt; a batch the tier sheds as
    expired lands as ``None`` in the results (the stream keeps going —
    a missed budget is an answer, not a tier failure).

    The shed-retry pause runs on the router's injected clock and is
    interruptible by ``router.close()`` — a teardown mid-stream no
    longer waits out ``shed_retry_s`` (and a ``FakeClock`` tier
    advances through it without real sleeping). A close that lands
    during the pause surfaces as ``PipelineClosed`` from the next
    submit.
    """
    if controller is not None and swap_after and swap_after >= len(stream):
        # Misconfiguration, not a quiet no-op — and caught BEFORE the
        # workload runs, not after minutes of serving.
        raise ValueError(
            f"swap_after={swap_after} would never fire: the stream has "
            f"only {len(stream)} batches"
        )
    swap_state: dict = {}
    swap_thread: Optional[threading.Thread] = None

    def run_swap():
        try:
            swap_state["report"] = controller.swap_all(snapshot)
        except BaseException as e:  # surfaced after the stream
            swap_state["error"] = e

    tickets = []
    downstream_error: Optional[BaseException] = None
    for n_submitted, batch in enumerate(stream):
        if controller is not None and swap_after \
                and n_submitted == swap_after:
            swap_thread = threading.Thread(target=run_swap, daemon=True)
            swap_thread.start()
        deadline = (
            None if deadline_s is None
            else router.clock.now() + deadline_s
        )
        while downstream_error is None:
            try:
                tickets.append(router.submit(batch, deadline=deadline))
                break
            except DeadlineExpired:
                tickets.append(None)  # budget spent waiting out sheds
                break
            except RequestShed:
                # Interruptible: router.close() sets _close_event, so a
                # teardown mid-pause wakes immediately (the next submit
                # raises PipelineClosed); a FakeClock advances through
                # it without real sleeping.
                router.clock.wait(router._close_event, shed_retry_s)
            except (AllReplicasDown, IncompatibleVersion) as e:
                # Tier down, or a versioned batch no replica can ever
                # serve: terminal either way — stop submitting.
                downstream_error = e
        if downstream_error is not None:
            break
    results = []
    try:
        for t in tickets:
            if t is None:
                results.append(None)
                continue
            try:
                results.append(t.result())
            except DeadlineExpired:
                if deadline_s is None:
                    raise  # caller-provided deadlines surface as errors
                results.append(None)  # a missed budget, not a failure
    except BaseException as e:
        downstream_error = downstream_error or e
    if swap_thread is not None:
        swap_thread.join()
    if "error" in swap_state:
        raise swap_state["error"]
    if downstream_error is not None:
        raise downstream_error
    return results, swap_state.get("report")
