"""The distributed engine of the PyTorch port (``repro_torch/index/engine.py``,
``repro_torch/launch/mesh.py``, ``launch/lifecycle.EngineBuilder``) against
the JAX reference (``repro/index/engine.py``).

The reference runs as ``tests/test_engine_fused.py`` runs it: in a
subprocess with 8 forced host devices, on a ``jax.make_mesh((4, 2))`` mesh
with the "xla" leaves. It runs once for this module (a module-scoped
fixture): the numpy inputs, made from a seed, go to it in an ``.npz`` and
its outputs come back in another. The port runs on ``LeafMesh((4, 2),
devices=["cpu"] * 8)`` with its plain leaves. Every case is bit-identical,
scores (-inf included) and ids: the flat engine, int8 and packed, at k = 10
and at k above a leaf's rows; an n_levels-1 corpus full of ties; failover
with leaf 3 dead, and with every leaf but one dead at k above its rows, so
that dead leaves' ids surface beside -inf; a reversed ``shard_axes`` and
a subset of the mesh's axes; the HNSW engine, int8 and
packed; both snapshot closures, bi-granular at every effort level; the
reference's errors; and ``EngineBuilder`` over two replica meshes. The
port's ``doc_inv_norms`` may differ from the reference's by one ulp, so the
port takes the reference's inverse norms. ``gpu`` cases hold the card's
engine against the same engine on the CPU.
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.sdc import ref as RR  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.index import engine as PE  # noqa: E402
from repro_torch.index import hnsw_lite as PH  # noqa: E402
from repro_torch.kernels.sdc import gather as PG  # noqa: E402
from repro_torch.kernels.sdc import ref as PR  # noqa: E402
from repro_torch.kernels.sdc import sdc as PS  # noqa: E402
from repro_torch.kernels.sdc.ops import sdc_search_torch  # noqa: E402
from repro_torch.launch import lifecycle as PL  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    LeafMesh,
    make_host_mesh,
    make_production_mesh,
    make_replica_meshes,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LEVELS, N, D, Q = 4, 2048, 64, 8
SHARD_N = N // 8
WIDE_K = SHARD_N + 44  # above a leaf's rows
TIES_D = 8  # n_levels 1 at code dim 8: 256 distinct rows for 2048 documents
RR_ARGS = {"coarse_levels": 2, "k_coarse": 64}
HNSW_KW = dict(M=8, ef_construction=32)
HNSW_SEARCH = dict(ef=64, beam=16)
# shard axes other than the mesh's own order: reversed, and a subset (the
# corpus split over "data" only, each shard on the leaf at model 0)
AXES = (("reversed", ("model", "data")), ("subset", ("data",)))

_REFERENCE = """
import json, sys, types
import numpy as np, jax, jax.numpy as jnp
from repro.core.binarize_lib import pack_codes_nibbles
from repro.index import engine as E
from repro.index.hnsw_lite import build_hnsw_sharded
from repro.kernels.sdc import ref as R
from repro.launch import lifecycle as L
from repro.launch.mesh import make_replica_meshes

inp = dict(np.load(sys.argv[1]))
cd, cq, td, tq = inp["cd"], inp["cq"], inp["td"], inp["tq"]
out, msgs = {}, {}
mesh = jax.make_mesh((4, 2), ("data", "model"))
qs, ds, vs = E.engine_input_shardings(mesh)


def save(name, res):
    out[name + "/v"], out[name + "/i"] = (np.asarray(x) for x in res[:2])


inv = np.asarray(R.doc_inv_norms(jnp.asarray(cd), 4))
tinv = np.asarray(R.doc_inv_norms(jnp.asarray(td), 1))
out["inv"], out["tinv"] = inv, tinv
packed_cd = pack_codes_nibbles(jnp.asarray(cd))
with mesh:
    q = jax.device_put(jnp.asarray(cq), qs)
    for packed in (False, True):
        d = jax.device_put(packed_cd if packed else jnp.asarray(cd), ds)
        v = jax.device_put(jnp.asarray(inv), vs)
        for k in (10, %(WIDE_K)d):
            fn = E.make_distributed_search(mesh, n_levels=4, k=k, backend="xla", packed=packed)
            save(f"flat/{int(packed)}/{k}", fn(q, d, v))
    tq_ = jax.device_put(jnp.asarray(tq), qs)
    for k in (10, 40):
        fn = E.make_distributed_search(mesh, n_levels=1, k=k, backend="xla")
        save(f"ties/{k}", fn(tq_, jax.device_put(jnp.asarray(td), ds),
                             jax.device_put(jnp.asarray(tinv), vs)))
    d = jax.device_put(jnp.asarray(cd), ds)
    v = jax.device_put(jnp.asarray(inv), vs)
    for name, axes in %(AXES)r:
        qa, da, va = E.engine_input_shardings(mesh, axes)
        fn = E.make_distributed_search(mesh, n_levels=4, k=10, backend="xla", shard_axes=axes)
        save(f"axes/{name}", fn(jax.device_put(jnp.asarray(cq), qa),
                                jax.device_put(jnp.asarray(cd), da),
                                jax.device_put(jnp.asarray(inv), va)))
        fn = E.make_distributed_search(mesh, n_levels=1, k=40, backend="xla", shard_axes=axes)
        save(f"axes_ties/{name}", fn(jax.device_put(jnp.asarray(tq), qa),
                                     jax.device_put(jnp.asarray(td), da),
                                     jax.device_put(jnp.asarray(tinv), va)))
    for name, k, alive in (("leaf3", 10, [i != 3 for i in range(8)]),
                           ("only5", %(WIDE_K)d, [i == 5 for i in range(8)])):
        fn = E.make_failover_search(mesh, n_levels=4, k=k, backend="xla")
        save(f"failover/{name}", fn(q, d, v, jnp.asarray(alive)))
    shards = E.hnsw_engine_shardings(mesh)
    for packed in (False, True):
        sh = build_hnsw_sharded(cd, inv, n_leaves=8, n_levels=4, seed=0, packed=packed,
                                **%(HNSW_KW)r)
        ins = [jax.device_put(a, s) for a, s in zip(E.hnsw_engine_inputs(sh), shards[1:])]
        fn = E.make_hnsw_search(mesh, n_levels=4, k=10, backend="xla", packed=packed,
                                **%(HNSW_SEARCH)r)
        save(f"hnsw/{int(packed)}", fn(q, *ins))
    sh16 = build_hnsw_sharded(cd, inv, n_leaves=16, n_levels=4, seed=0, **%(HNSW_KW)r)
    ins = [jax.device_put(a, s) for a, s in zip(E.hnsw_engine_inputs(sh16), shards[1:])]
    try:
        E.make_hnsw_search(mesh, n_levels=4, k=10, backend="xla")(q, *ins)
    except ValueError as e:
        msgs["leaf_count"] = str(e)

snap = L.CorpusSnapshot(codes=cd, n_levels=4)
for packed in (False, True):
    save(f"snap/{int(packed)}", E.engine_search_from_snapshot(
        mesh, snap, k=10, backend="xla", packed=packed)(cq))
    knob = types.SimpleNamespace(level=0)
    fn = E.engine_search_from_snapshot(mesh, snap, k=10, backend="xla", packed=packed,
                                       rerank=%(RR_ARGS)r, effort=knob)
    for level in (0, 1, 2):
        knob.level = level
        save(f"snap_rr/{int(packed)}/{level}", fn(cq))
save("snap_rr/none", E.engine_search_from_snapshot(mesh, snap, k=10, backend="xla",
                                                    rerank=%(RR_ARGS)r)(cq))
save("snap_hnsw", E.hnsw_engine_search_from_snapshot(mesh, snap, k=10, backend="xla",
                                                     **%(HNSW_KW)r, **%(HNSW_SEARCH)r)(cq))
sh4 = build_hnsw_sharded(cd, inv, n_leaves=4, n_levels=4, seed=0, **%(HNSW_KW)r)
try:
    E.hnsw_engine_search_from_snapshot(mesh, snap, k=10, backend="xla", sharded=sh4)
except ValueError as e:
    msgs["prebuilt"] = str(e)

meshes = make_replica_meshes(2, (2, 2))
tags = {}
for index, extra in (("flat", {}), ("hnsw", {}), ("flat_rr", %(RR_ARGS)r)):
    b = L.EngineBuilder(meshes, index=index.split("_")[0], n_levels=4, k=10, backend="auto",
                        **extra)
    for replica in (0, 1):
        save(f"builder/{index}/{replica}", b.build(snap, replica=replica)(cq))
    tags[index] = [L.builder_version(b, snap).tag,
                   repr(L.builder_version(b, snap).build_params)]
np.savez(sys.argv[2], **out)
json.dump({"msgs": msgs, "tags": tags}, open(sys.argv[3], "w"))
""" % dict(WIDE_K=WIDE_K, HNSW_KW=HNSW_KW, HNSW_SEARCH=HNSW_SEARCH, RR_ARGS=RR_ARGS,
           AXES=AXES)


def _inputs(seed=20):
    rng = np.random.default_rng(seed)
    return dict(
        cd=rng.integers(0, 2**LEVELS, (N, D)).astype(np.int8),
        cq=rng.integers(0, 2**LEVELS, (Q, D)).astype(np.int8),
        td=rng.integers(0, 2, (N, TIES_D)).astype(np.int8),
        tq=rng.integers(0, 2, (Q, TIES_D)).astype(np.int8),
    )


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Inputs and the reference's outputs, from one subprocess."""
    tmp = tmp_path_factory.mktemp("engine")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(tmp / "in.npz"),
         str(tmp / "out.npz"), str(tmp / "out.json")],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = dict(np.load(tmp / "out.npz"))
    res.update(inp)
    res.update(json.load(open(tmp / "out.json")))
    return res


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's builds take the reference's inverse norms."""
    def doc_inv_norms(codes, n_levels):
        inv = RR.doc_inv_norms(jnp.asarray(codes.cpu().numpy()), n_levels)
        return torch.from_numpy(np.array(inv)).to(codes.device)

    monkeypatch.setattr(PR, "doc_inv_norms", doc_inv_norms)


def _mesh():
    return make_host_mesh((4, 2), devices=["cpu"] * 8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(ref, name, got):
    gv, gi = (x.cpu().numpy() for x in got[:2])
    assert np.array_equal(gi, ref[name + "/i"]), name
    assert np.array_equal(gv.view(np.uint32), ref[name + "/v"].view(np.uint32)), name


def _pack(codes):
    return PB.pack_codes_nibbles(_t(codes))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_leaf_mesh_layout():
    mesh = LeafMesh((4, 2), ("data", "model"), [f"cpu:{i}" for i in range(8)])
    assert mesh.n_leaves == 8 and mesh.axis_size("model") == 2
    # rank = data * 2 + model over both axes; model * 4 + data reversed;
    # over "data" alone a leaf sits at model 0
    assert [d.index for d in mesh.leaf_devices(("data", "model"))] == list(range(8))
    assert [d.index for d in mesh.leaf_devices(("model", "data"))] == [0, 2, 4, 6, 1, 3, 5, 7]
    assert [d.index for d in mesh.leaf_devices(("data",))] == [0, 2, 4, 6]
    with pytest.raises(ValueError, match="no axis 'pod'"):
        mesh.leaf_devices(("pod",))
    with pytest.raises(ValueError, match="needs 8 devices, got 7"):
        LeafMesh((4, 2), ("data", "model"), ["cpu"] * 7)


def test_meshes_take_an_explicit_device_list():
    reps = make_replica_meshes(2, (2, 2), devices=["cpu"] * 8)
    assert len(reps) == 2 and all(m.shape == (2, 2) and m.n_leaves == 4 for m in reps)
    prod = make_production_mesh(devices=["cpu"] * 256)
    assert prod.shape == (16, 16) and prod.axes == ("data", "model")
    multi = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert multi.shape == (2, 16, 16) and multi.axes == ("pod", "data", "model")
    with pytest.raises(RuntimeError, match=r"need 8 devices \(2 replicas x 4\), have 7"):
        make_replica_meshes(2, (2, 2), devices=["cpu"] * 7)
    with pytest.raises(RuntimeError, match="need 4 devices, have 3"):
        make_host_mesh(devices=["cpu"] * 3)


def test_meshes_default_to_the_cards():
    if torch.cuda.is_available():
        assert make_host_mesh((1,), ("data",)).devices[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="need 4 devices, have 0"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="need 256 devices, have 0"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match=r"need 8 devices \(2 replicas x 4\), have 0"):
        make_replica_meshes(2)


# ---------------------------------------------------------------------------
# the engines against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [10, WIDE_K])
@pytest.mark.parametrize("packed", [False, True])
def test_flat_engine_equals_reference(ref, packed, k):
    fn = PE.make_distributed_search(_mesh(), n_levels=LEVELS, k=k, packed=packed)
    codes = _pack(ref["cd"]) if packed else _t(ref["cd"])
    got = fn(_t(ref["cq"]), codes, _t(ref["inv"]))
    _same(ref, f"flat/{int(packed)}/{k}", got)
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("k", [10, 40])
def test_ties_equal_reference(ref, k):
    fn = PE.make_distributed_search(_mesh(), n_levels=1, k=k)
    got = fn(_t(ref["tq"]), _t(ref["td"]), _t(ref["tinv"]))
    _same(ref, f"ties/{k}", got)
    v = got[0].numpy()
    assert (v[:, 1:] == v[:, :-1]).any()  # the case really holds ties


@pytest.mark.parametrize("name, axes", AXES)
def test_shard_axes_equal_reference(ref, name, axes):
    """A reversed ``shard_axes`` and a subset of the mesh's axes: the leaves
    and the merge order follow the reference, ties included."""
    mesh = _mesh()
    fn = PE.make_distributed_search(mesh, n_levels=LEVELS, k=10, shard_axes=axes)
    _same(ref, f"axes/{name}", fn(_t(ref["cq"]), _t(ref["cd"]), _t(ref["inv"])))
    fn = PE.make_distributed_search(mesh, n_levels=1, k=40, shard_axes=axes)
    got = fn(_t(ref["tq"]), _t(ref["td"]), _t(ref["tinv"]))
    _same(ref, f"axes_ties/{name}", got)
    v = got[0].numpy()
    assert (v[:, 1:] == v[:, :-1]).any()  # the case really holds ties
    assert len(mesh.leaf_devices(axes)) == (8 if len(axes) == 2 else 4)


@pytest.mark.parametrize("case", ["leaf3", "only5"])
def test_failover_equals_reference(ref, case):
    k = 10 if case == "leaf3" else WIDE_K
    alive = torch.tensor([i != 3 if case == "leaf3" else i == 5 for i in range(8)])
    fn = PE.make_failover_search(_mesh(), n_levels=LEVELS, k=k)
    got = fn(_t(ref["cq"]), _t(ref["cd"]), _t(ref["inv"]), alive)
    _same(ref, f"failover/{case}", got)
    v, i = got
    dead = torch.isinf(v) & (i >= 0) & ((i < 5 * SHARD_N) | (i >= 6 * SHARD_N))
    if case == "leaf3":
        assert not bool(((i >= 3 * SHARD_N) & (i < 4 * SHARD_N)).any())
    else:  # the survivor's rows, then dead leaves' ids beside -inf
        assert bool(torch.isfinite(v[:, :SHARD_N]).all()) and bool(dead[:, SHARD_N:].all())


def test_failover_mask_flips_without_rebuild(ref):
    fn = PE.make_failover_search(_mesh(), n_levels=LEVELS, k=10)
    args = (_t(ref["cq"]), _t(ref["cd"]), _t(ref["inv"]))
    alive = torch.ones(8, dtype=torch.bool)
    _same(ref, "flat/0/10", fn(*args, alive))
    alive[3] = False
    _same(ref, "failover/leaf3", fn(*args, alive))
    alive[3] = True
    _same(ref, "flat/0/10", fn(*args, alive))


@pytest.mark.parametrize("packed", [False, True])
def test_hnsw_engine_equals_reference(ref, packed):
    sh = PH.build_hnsw_sharded(ref["cd"], ref["inv"], n_leaves=8, n_levels=LEVELS, seed=0,
                               packed=packed, device="cpu", **HNSW_KW)
    fn = PE.make_hnsw_search(_mesh(), n_levels=LEVELS, k=10, packed=packed, **HNSW_SEARCH)
    reads = PH.hnsw_frontier_search.host_reads
    _same(ref, f"hnsw/{int(packed)}", fn(_t(ref["cq"]), *PE.hnsw_engine_inputs(sh)))
    assert PH.hnsw_frontier_search.host_reads >= reads + 8  # every leaf's hops count


@pytest.mark.parametrize("packed", [False, True])
def test_engine_snapshot_closure_equals_reference(ref, reference_norms, packed):
    snap = PL.CorpusSnapshot(codes=ref["cd"], n_levels=LEVELS)
    fn = PE.engine_search_from_snapshot(_mesh(), snap, k=10, packed=packed)
    _same(ref, f"snap/{int(packed)}", fn(ref["cq"]))
    prepared = PE.flat_engine_inputs_from_snapshot(ref["cd"], LEVELS, packed=packed,
                                                   device="cpu")
    fn = PE.engine_search_from_snapshot(_mesh(), ref["cd"], LEVELS, k=10, packed=packed,
                                        prepared=prepared)
    _same(ref, f"snap/{int(packed)}", fn(_t(ref["cq"])))
    assert len(fn.leaf_inputs) == 2 and len(fn.leaf_inputs[0]) == 8
    # on one device the leaves hold views of the prepared tensors
    assert fn.leaf_inputs[0][3].data_ptr() == prepared[0][3 * SHARD_N:].data_ptr()


@pytest.mark.parametrize("fine", ["numpy", "tensor"])
@pytest.mark.parametrize("packed", [False, True])
def test_bigranular_engine_equals_reference_at_every_effort(ref, reference_norms, packed, fine):
    codes = ref["cd"] if fine == "numpy" else _t(ref["cd"])
    knob = types.SimpleNamespace(level=0)
    fn = PE.engine_search_from_snapshot(_mesh(), PL.CorpusSnapshot(codes, LEVELS), k=10,
                                        packed=packed, rerank=RR_ARGS, effort=knob)
    assert fn.reranked is True and fn.effort is knob
    for level in (0, 1, 2):
        knob.level = level
        _same(ref, f"snap_rr/{int(packed)}/{level}", fn(ref["cq"]))
    plain = PE.engine_search_from_snapshot(_mesh(), codes, LEVELS, k=10, rerank=RR_ARGS)
    assert not hasattr(plain, "effort")
    _same(ref, "snap_rr/none", plain(ref["cq"]))


def test_hnsw_snapshot_closure_equals_reference(ref, reference_norms):
    snap = PL.CorpusSnapshot(codes=ref["cd"], n_levels=LEVELS)
    fn = PE.hnsw_engine_search_from_snapshot(_mesh(), snap, k=10, **HNSW_KW, **HNSW_SEARCH)
    _same(ref, "snap_hnsw", fn(ref["cq"]))


def test_leaf_count_mismatches_raise_the_reference_messages(ref):
    sh16 = PH.build_hnsw_sharded(ref["cd"], ref["inv"], n_leaves=16, n_levels=LEVELS, seed=0,
                                 device="cpu", **HNSW_KW)
    fn = PE.make_hnsw_search(_mesh(), n_levels=LEVELS, k=10)
    with pytest.raises(ValueError) as e:
        fn(_t(ref["cq"]), *PE.hnsw_engine_inputs(sh16))
    assert str(e.value) == ref["msgs"]["leaf_count"]
    sh4 = PH.build_hnsw_sharded(ref["cd"], ref["inv"], n_leaves=4, n_levels=LEVELS, seed=0,
                                device="cpu", **HNSW_KW)
    with pytest.raises(ValueError) as e:
        PE.hnsw_engine_search_from_snapshot(_mesh(), ref["cd"], LEVELS, k=10, sharded=sh4)
    assert str(e.value) == ref["msgs"]["prebuilt"]


@pytest.mark.parametrize("index", ["flat", "hnsw", "flat_rr"])
def test_engine_builder_replicas_equal_reference(ref, reference_norms, index):
    meshes = make_replica_meshes(2, (2, 2), devices=["cpu"] * 8)
    extra = RR_ARGS if index == "flat_rr" else {}
    b = PL.EngineBuilder(meshes, index=index.split("_")[0], n_levels=LEVELS, k=10,
                         backend="auto", **extra)
    snap = PL.CorpusSnapshot(codes=ref["cd"], n_levels=LEVELS)
    fns = [b.build(snap, replica=r) for r in (0, 1)]
    for r, fn in enumerate(fns):
        _same(ref, f"builder/{index}/{r}", fn(ref["cq"]))
    version = PL.builder_version(b, snap)
    assert [version.tag, repr(version.build_params)] == ref["tags"][index]
    # one artifact per digest, and both replicas' leaves hold its storage
    assert len(b._flat_cache) + len(b._graph_cache) == 1
    for a, c in zip(fns[0].leaf_inputs, fns[1].leaf_inputs):
        assert [t.data_ptr() for t in a] == [t.data_ptr() for t in c]


# ---------------------------------------------------------------------------
# port-only cases
# ---------------------------------------------------------------------------


def _flat_in_gather_order(cq, cd, inv, k, order):
    """A flat search's top-k with ties put in the merge's order: score, then
    the leaf's place in ``order``, then id."""
    v, i = sdc_search_torch(cq, cd, inv, n_levels=LEVELS, k=cd.shape[0])
    place = torch.tensor(order).argsort()[i.long() // (cd.shape[0] // len(order))]
    by_place = torch.sort(place, dim=1, stable=True).indices
    v, i = v.gather(1, by_place), i.gather(1, by_place)
    by_score = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return v.gather(1, by_score), i.gather(1, by_score)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape, axes, order", [
    ((8,), ("data",), list(range(8))),
    ((4, 2), ("data", "model"), [0, 2, 4, 6, 1, 3, 5, 7]),
    ((2, 2, 2), ("pod", "data", "model"), [0, 4, 2, 6, 1, 5, 3, 7]),
])
def test_merge_equals_one_flat_search(shape, axes, order, packed):
    """Duplicated documents tie across leaves: over one sharded axis the
    merge is a flat search, ties included; over several, a flat search
    whose ties follow the gather order."""
    rng = np.random.default_rng(5)
    cd = _t(rng.integers(0, 2**LEVELS, (800, 32)).astype(np.int8))
    cq = _t(rng.integers(0, 2**LEVELS, (5, 32)).astype(np.int8))
    cd[::7] = cd[3]
    inv = PR.doc_inv_norms(cd, LEVELS)
    mesh = make_host_mesh(shape, axes, devices=["cpu"] * 8)
    assert PE.gather_order(mesh, axes) == order
    corpus = PB.pack_codes_nibbles(cd) if packed else cd
    for k in (1, 10, 150):
        fn = PE.make_distributed_search(mesh, n_levels=LEVELS, k=k, shard_axes=axes,
                                        packed=packed)
        got = fn(cq, corpus, inv)
        want = _flat_in_gather_order(cq, cd, inv, k, order)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        if len(axes) == 1:
            want = sdc_search_torch(cq, cd, inv, n_levels=LEVELS, k=k)
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_placement_and_checks():
    mesh = _mesh()
    q, codes, inv = PE.engine_input_shardings(mesh)
    x = torch.arange(16)
    assert all(t is x for t in q.place(x))
    parts = codes.place(x)
    assert [p.tolist() for p in parts] == [[2 * i, 2 * i + 1] for i in range(8)]
    assert all(p.data_ptr() == x[2 * i:].data_ptr() for i, p in enumerate(parts))
    assert codes.place(parts) == parts
    with pytest.raises(ValueError, match="cannot shard 2050 rows evenly over 8 leaves"):
        codes.place(torch.zeros(2050))
    with pytest.raises(ValueError, match="got 3 per-leaf tensors for 8 leaves"):
        codes.place(parts[:3])
    fn = PE.make_distributed_search(mesh, n_levels=LEVELS, k=5)
    with pytest.raises(ValueError, match="2050 rows evenly over 8 leaves"):
        fn(torch.zeros((2, 8), dtype=torch.int8), torch.zeros((2050, 8), dtype=torch.int8),
           torch.ones(2050))
    with pytest.raises(ValueError, match="blocks must be >= 1"):
        PE.make_distributed_search(mesh, n_levels=LEVELS, k=5, block_q=0)
    with pytest.raises(ValueError, match="backend 'cuda' needs CUDA tensors"):
        PE.make_distributed_search(mesh, n_levels=LEVELS, k=5, backend="cuda")
    with pytest.raises(ValueError, match="unknown SDC backend 'xla'"):
        PE.make_hnsw_search(mesh, n_levels=LEVELS, k=5, backend="xla")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_engines_on_card_equal_the_cpu(card, monkeypatch, packed):
    rng = np.random.default_rng(7)
    cd = rng.integers(0, 2**LEVELS, (4000, 128)).astype(np.int8)
    cq = rng.integers(0, 2**LEVELS, (33, 128)).astype(np.int8)
    on_card = make_host_mesh(devices=[card] * 4)
    on_cpu = make_host_mesh(devices=["cpu"] * 4)
    cases = [
        dict(k=10), dict(k=10, rerank=RR_ARGS),
    ]

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for kw in cases:
        want = PE.engine_search_from_snapshot(on_cpu, cd, LEVELS, packed=packed, **kw)(cq)
        fn = PE.engine_search_from_snapshot(on_card, cd, LEVELS, packed=packed, **kw)
        with monkeypatch.context() as m:
            m.setattr(PS, "sdc_topk_torch", plain)
            m.setattr(PG, "sdc_gather_topk_torch", plain)
            before = PS.sdc_topk.launches, PG.sdc_gather_topk.launches
            got = fn(cq)
            torch.cuda.synchronize()
            assert (PS.sdc_topk.launches - before[0], PG.sdc_gather_topk.launches - before[1]) \
                == (4, 1 if "rerank" in kw else 0)
        assert got[0].device.type == "cuda"
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    sh = PE.sharded_graph_from_snapshot(cd, LEVELS, n_leaves=4, packed=packed, device="cpu")
    want = PE.hnsw_engine_search_from_snapshot(on_cpu, cd, LEVELS, k=10, packed=packed,
                                               sharded=sh)(cq)
    got = PE.hnsw_engine_search_from_snapshot(on_card, cd, LEVELS, k=10, packed=packed)(cq)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
