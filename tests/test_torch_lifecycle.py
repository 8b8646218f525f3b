"""The builder half of the live index lifecycle in the PyTorch port
(``repro_torch/launch/lifecycle.py``) against the JAX reference
(``repro/launch/lifecycle.py``), in one process on the CPU.

``CorpusSnapshot``'s digest (numpy, torch and memmap codes), equality,
hash and ``spilled``; ``builder_version`` tags; ``make_builder``'s errors
(their messages too); and the Flat, IVF and HNSW builders' results,
bi-granular included, are held against the reference on the same numpy
inputs. The port's ``doc_inv_norms`` may differ from the reference's by
one ulp, so its builds take the reference's inverse norms, and its IVF
k-means starts from the reference's k-means++ picks. The last case,
``EngineBuilder`` over two replica meshes, is the port's alone; its
results are held against one flat search (and against the reference's
``EngineBuilder`` in ``tests/test_torch_engine.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.index import kmeans as RK  # noqa: E402
from repro.kernels.sdc import ref as RR  # noqa: E402
from repro.launch import lifecycle as RL  # noqa: E402
from repro_torch.index import kmeans as PK  # noqa: E402
from repro_torch.kernels.sdc import ref as PR  # noqa: E402
from repro_torch.kernels.sdc.ops import sdc_search_torch  # noqa: E402
from repro_torch.launch import lifecycle as PL  # noqa: E402
from repro_torch.launch.mesh import make_replica_meshes  # noqa: E402

LEVELS = 4

# the reference's lifecycle test parameters, per family
BUILDER_PARAMS = {
    "flat": dict(k=10),
    "ivf": dict(k=10, nlist=8, nprobe=4, kmeans_iters=3, seed=1),
    "hnsw": dict(k=10, M=8, ef_construction=24, ef=24, beam=8, seed=0),
}
RERANK = dict(coarse_levels=2, k_coarse=32)


def _code_corpus(n=600, q=24, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    cd = rng.integers(0, 2**LEVELS, (n, dim)).astype(np.int8)
    cq = rng.integers(0, 2**LEVELS, (q, dim)).astype(np.int8)
    return cd, cq


def _same(want, got):
    wv, wi = (np.asarray(x) for x in want)
    gv, gi = (x.cpu().numpy() for x in got)
    assert np.array_equal(gi, wi)
    assert np.array_equal(gv.view(np.uint32), wv.view(np.uint32))


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's builds take the reference's inverse norms."""
    def doc_inv_norms(codes, n_levels):
        inv = RR.doc_inv_norms(jnp.asarray(codes.cpu().numpy()), n_levels)
        return torch.from_numpy(np.array(inv)).to(codes.device)

    monkeypatch.setattr(PR, "doc_inv_norms", doc_inv_norms)


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's k-means starts from the reference's k-means++ picks for ``seed``."""
    def hand_over(seed):
        def kmeans_pp_init(key, x, k):
            init = RK.kmeans_pp_init(jax.random.PRNGKey(seed), jnp.asarray(x.cpu().numpy()), k)
            return torch.from_numpy(np.array(init)).to(x.device)

        monkeypatch.setattr(PK, "kmeans_pp_init", kmeans_pp_init)

    return hand_over


# ---------------------------------------------------------------------------
# snapshots + versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["numpy", "torch", "memmap"])
def test_snapshot_digest_equals_reference(tmp_path, form):
    cd, _ = _code_corpus()
    want = RL.CorpusSnapshot(codes=cd, n_levels=LEVELS)
    codes = {"numpy": lambda: cd.copy(), "torch": lambda: torch.from_numpy(cd.copy()),
             "memmap": lambda: PL.CorpusSnapshot(cd, LEVELS).spilled(tmp_path / "c.bin").codes}
    snap = PL.CorpusSnapshot(codes=codes[form](), n_levels=LEVELS)
    assert snap.digest == want.digest
    assert hash(snap) == hash(want)  # the same (digest, n_levels, version) tuple
    changed = cd.copy()
    changed[0, 0] = (changed[0, 0] + 1) % (2**LEVELS)
    assert PL.CorpusSnapshot(changed, LEVELS).digest == RL.CorpusSnapshot(changed, LEVELS).digest
    assert PL.CorpusSnapshot(changed, LEVELS).digest != snap.digest


def test_snapshot_equality_and_hash_go_through_digest():
    cd, _ = _code_corpus(n=64)
    a = PL.CorpusSnapshot(codes=cd, n_levels=LEVELS)
    b = PL.CorpusSnapshot(codes=torch.from_numpy(cd.copy()), n_levels=LEVELS)
    assert a == b and hash(a) == hash(b)  # content, not identity
    assert a != PL.CorpusSnapshot(codes=cd, n_levels=LEVELS, embedding_version="v1")
    assert a != PL.CorpusSnapshot(codes=cd, n_levels=3)
    assert a != RL.CorpusSnapshot(codes=cd, n_levels=LEVELS)  # another package's type
    assert len({a, b}) == 1  # usable as a dict/set key


def test_snapshot_digest_is_computed_once():
    cd, _ = _code_corpus(n=64)
    snap = PL.CorpusSnapshot(codes=cd, n_levels=LEVELS)
    d = snap.digest
    assert "digest" in snap.__dict__
    assert snap.digest is d


def test_spilled_keeps_the_digest(tmp_path):
    cd, _ = _code_corpus(n=64)
    snap = PL.CorpusSnapshot(codes=torch.from_numpy(cd), n_levels=LEVELS, embedding_version="v2")
    cold = snap.spilled(tmp_path / "codes.bin")
    assert isinstance(cold.codes, np.memmap) and not cold.codes.flags.writeable
    assert cold == snap and cold.embedding_version == "v2"
    want = RL.CorpusSnapshot(codes=cd, n_levels=LEVELS).spilled(tmp_path / "ref.bin")
    assert cold.digest == want.digest


def _fields(version):
    """An ``IndexVersion``'s fields (the two packages' classes never compare equal)."""
    return dataclasses.astuple(version)


@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw"])
def test_builder_version_equals_reference(kind):
    cd, _ = _code_corpus(n=64)
    snaps = (PL.CorpusSnapshot(cd, LEVELS, "v3"), RL.CorpusSnapshot(cd, LEVELS, "v3"))
    for params in (BUILDER_PARAMS[kind], {**BUILDER_PARAMS[kind], **RERANK}):
        params = dict(params, backend="auto")
        got = PL.builder_version(PL.make_builder(kind, device="cpu", **params), snaps[0])
        want = RL.builder_version(RL.make_builder(kind, **params), snaps[1])
        assert _fields(got) == _fields(want) and got.tag == want.tag
    assert got.tag.startswith(f"{kind}:v3:") and ("coarse_levels", 2) in got.build_params
    if kind == "ivf":
        v = PL.builder_version(PL.make_builder("ivf", **BUILDER_PARAMS["ivf"]), snaps[0])
        assert ("nlist", 8) in v.build_params and v.corpus_digest == snaps[0].digest
        v2 = PL.builder_version(PL.make_builder("ivf", k=10, nlist=4, nprobe=4), snaps[0])
        assert v2 != v and v2.corpus_digest == v.corpus_digest
    # where the index lives is not a build parameter
    assert "device" not in PL.make_builder(kind, device="cpu").params


def test_engine_builder_version_equals_reference():
    cd, _ = _code_corpus(n=64)
    for kw in (dict(index="flat"), dict(index="hnsw", beam=8), dict(index="flat", **RERANK)):
        got = PL.builder_version(PL.EngineBuilder([], n_levels=LEVELS, **kw),
                                 PL.CorpusSnapshot(cd, LEVELS))
        want = RL.builder_version(RL.EngineBuilder([], n_levels=LEVELS, **kw),
                                  RL.CorpusSnapshot(cd, LEVELS))
        assert _fields(got) == _fields(want) and got.index_kind.startswith("engine-")


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as e:
        fn(*args, **kwargs)
    return type(e.value).__name__, str(e.value)


def test_make_builder_errors_equal_reference():
    assert _error(PL.make_builder, "pq") == _error(RL.make_builder, "pq")
    assert "unknown index builder 'pq'" in _error(PL.make_builder, "pq")[1]
    for kind, bad in (("ivf", dict(ef=8)), ("flat", dict(nprobe=2, k=5)),
                      ("hnsw", dict(probe_budget=4))):
        got = _error(PL.make_builder, kind, **bad)
        assert got == _error(RL.make_builder, kind, **bad)
        assert got[0] == "UnknownBuildParam"
    for kind in ("flat", "ivf", "hnsw"):
        assert _error(PL.make_builder, kind, coarse_levels=2) == _error(
            RL.make_builder, kind, coarse_levels=2)
    assert _error(PL.EngineBuilder, [], index="ivf", n_levels=4) == _error(
        RL.EngineBuilder, [], index="ivf", n_levels=4)
    assert _error(PL.EngineBuilder, [], index="hnsw", n_levels=4, **RERANK) == _error(
        RL.EngineBuilder, [], index="hnsw", n_levels=4, **RERANK)


# ---------------------------------------------------------------------------
# builders against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("kind", ["flat", "ivf", "hnsw"])
def test_builders_equal_reference(reference_norms, reference_draws, kind, rerank):
    cd, cq = _code_corpus()
    params = dict(BUILDER_PARAMS[kind], **(RERANK if rerank else {}))
    reference_draws(params.get("seed", 0))
    want = RL.make_builder(kind, backend="xla", **params).build(
        RL.CorpusSnapshot(cd, LEVELS))(jnp.asarray(cq))
    got_fn = PL.make_builder(kind, device="cpu", **params).build(PL.CorpusSnapshot(cd, LEVELS))
    assert getattr(got_fn, "reranked", False) is rerank
    _same(want, got_fn(torch.from_numpy(cq)))


def test_digest_cache_returns_one_closure(reference_norms):
    cd, cq = _code_corpus(n=128)
    builder = PL.make_builder("flat", device="cpu", k=5)
    a = builder.build(PL.CorpusSnapshot(cd, LEVELS))
    assert builder.build(PL.CorpusSnapshot(torch.from_numpy(cd.copy()), LEVELS), replica=1) is a
    assert len(builder._cache) == 1
    changed = cd.copy()
    changed[0, 0] ^= 1
    b = builder.build(PL.CorpusSnapshot(changed, LEVELS))
    assert b is not a and len(builder._cache) == 1  # at most one snapshot's index
    _same(sdc_search_torch(torch.from_numpy(cq), torch.from_numpy(changed),
                           PR.doc_inv_norms(torch.from_numpy(changed), LEVELS),
                           n_levels=LEVELS, k=5), b(cq))


def test_builders_default_to_the_card():
    cd, cq = _code_corpus(n=64)
    snap = PL.CorpusSnapshot(cd, LEVELS)
    if torch.cuda.is_available():
        v, i = PL.make_builder("flat").build(snap)(cq)
        assert v.device.type == "cuda"
        return
    for kind in ("flat", "ivf", "hnsw"):
        params = dict(BUILDER_PARAMS[kind], nlist=4) if kind == "ivf" else BUILDER_PARAMS[kind]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PL.make_builder(kind, **params).build(snap)


# ---------------------------------------------------------------------------
# the engine builder over two replica meshes (the port's alone)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(index="flat", packed=True), dict(index="hnsw", M=8),
                                dict(index="flat", **RERANK)])
def test_engine_builder_two_replicas_share_one_artifact(kw):
    cd, cq = _code_corpus(n=512)
    meshes = make_replica_meshes(2, (2, 2), devices=["cpu"] * 8)
    builder = PL.EngineBuilder(meshes, n_levels=LEVELS, k=10, **kw)
    snap = PL.CorpusSnapshot(cd, LEVELS, "v1")
    fns = [builder.build(snap, replica=r) for r in (0, 1)]
    outs = [fn(cq) for fn in fns]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert len(builder._flat_cache) + len(builder._graph_cache) == 1
    for a, b in zip(*(fn.leaf_inputs for fn in fns)):
        assert [t.data_ptr() for t in a] == [t.data_ptr() for t in b]
    if kw["index"] == "flat" and "coarse_levels" not in kw:
        # every slot live and no exact ties here: one flat search's result
        inv = PR.doc_inv_norms(torch.from_numpy(cd), LEVELS)
        want = sdc_search_torch(torch.from_numpy(cq), torch.from_numpy(cd), inv,
                                n_levels=LEVELS, k=10)
        assert all(torch.equal(a, b) for a, b in zip(outs[0], want))
    # a second build of the same snapshot reuses the artifact
    again = builder.build(PL.CorpusSnapshot(cd.copy(), LEVELS, "v1"), replica=1)
    assert [t.data_ptr() for t in again.leaf_inputs[0]] == \
        [t.data_ptr() for t in fns[1].leaf_inputs[0]]
