"""Version-aware serving in the port's tier (typed ``SearchRequest``s, the
``CompatibilityMatrix``, ``IncompatibleVersion``) against the reference's.

Both tiers serve the same world: untrained random-projection binarizers
(the reference's weights, handed to the port with ``binarizer_from_numpy``)
encode the same numpy documents and queries, and ``FlatBuilder`` indexes
them (the port's with the reference's inverse norms). Each case runs the
same requests through both tiers and compares results bit for bit, the
provenance (replica, served version, compat hop), the stats and the
errors, type and message.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_tier as W  # noqa: E402
from repro.core import BinarizerConfig as RBC  # noqa: E402
from repro.core import init_binarizer as r_init  # noqa: E402
from repro.core import make_encode_fn as r_encode_fn  # noqa: E402
from repro.index import flat as RFL  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.index import flat as PFL  # noqa: E402

DIM, CODE, LEVELS, K = 16, 8, 2, 5
N_DOCS, BATCH = 64, 4
PORT, REF = W.PORT, W.REF


def _encoders(seed):
    cfg = RBC(input_dim=DIM, code_dim=CODE, n_levels=LEVELS, hidden_dim=0)
    params, state = r_init(jax.random.PRNGKey(seed), cfg)
    pcfg = PB.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=LEVELS, hidden_dim=0)
    model = PB.binarizer_from_numpy(jax.tree_util.tree_map(np.array, params),
                                    jax.tree_util.tree_map(np.array, state), pcfg, device="cpu")
    return r_encode_fn(params, state, cfg), PB.make_encode_fn(model)


@pytest.fixture(scope="module")
def worlds():
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(N_DOCS, DIM)).astype(np.float32)
    queries = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    encs = {v: _encoders(seed) for v, seed in (("v1", 1), ("v2", 2), ("compat", 3))}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        W.hand_over_reference_inputs(mp, seed=0)
        for i, side in enumerate((REF, PORT)):
            builder = side.lifecycle.FlatBuilder(k=K, **side.build_kw)
            w = dict(queries=side.array(queries), builder=builder,
                     **{f"enc_{v}": e[i] for v, e in encs.items()})
            for v in ("v1", "v2"):
                snap = side.lifecycle.CorpusSnapshot(codes=W.host(encs[v][0](docs)),
                                                     n_levels=LEVELS, embedding_version=v)
                w[f"snap_{v}"] = snap
                w[f"search_{v}"] = builder.build(snap)
                w[f"ver_{v}"] = side.lifecycle.builder_version(builder, snap)
            out[side.name] = w
    return out


def _pair(worlds, scenario):
    """Run ``scenario(side, world)`` on both packages; the port's outcome."""
    want = scenario(REF, worlds["ref"])
    got = scenario(PORT, worlds["port"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple) and len(g) == 2 and not isinstance(g[0], str):
            assert W.same(w[0], g[0]) and W.same(w[1], g[1])
        else:
            assert g == w
    return got


def _provenance(res):
    return (res.served_by_version, res.replica, res.compat_encoded, res.generation,
            res.reranked)


def test_versions_and_tags_equal_reference(worlds):
    for v in ("v1", "v2"):
        got, want = worlds["port"][f"ver_{v}"], worlds["ref"][f"ver_{v}"]
        assert got.tag == want.tag and got.corpus_digest == want.corpus_digest
        assert got.tag.startswith(f"flat:{v}:")


# ---------------------------------------------------------------------------
# SearchRequest / SearchResult shapes and the error taxonomy
# ---------------------------------------------------------------------------


def test_search_request_validates_as_the_reference():
    seen = {}
    for side in (PORT, REF):
        SR = side.serving.SearchRequest
        seen[side.name] = [
            W.error_of(SR), W.error_of(SR, queries=np.zeros((1, 2)), codes=np.zeros((1, 2))),
            W.error_of(SR, queries=np.zeros((1, 2)), k=0),
            SR(queries=side.array(np.zeros((3, 2)))).n_queries]
    assert seen["port"] == seen["ref"] and seen["port"][-1] == 3


def test_search_result_unpacks_like_tuple():
    r = W.PS.SearchResult(scores=torch.arange(2), ids=torch.arange(2) + 10,
                          served_by_version="v1", replica=0, generation=1)
    vals, ids = r
    assert torch.equal(vals, r.scores) and torch.equal(ids, r.ids)
    assert torch.equal(r[0], r.scores) and torch.equal(r[1], r.ids) and len(r) == 2


def test_error_taxonomy():
    P = W.PS
    assert issubclass(P.IncompatibleVersion, RuntimeError)
    assert not issubclass(P.IncompatibleVersion, P.RequestShed)
    assert not issubclass(P.IncompatibleVersion, W.PP.AllReplicasDown)
    assert W.PP.IncompatibleVersion is P.IncompatibleVersion


# ---------------------------------------------------------------------------
# pipeline-level: typed path vs legacy shim
# ---------------------------------------------------------------------------


def test_bare_batch_request_codes_and_k_paths(worlds):
    def scenario(side, w):
        S = side.serving
        ref = S.serve_sequential(w["enc_v1"], w["search_v1"], [w["queries"]])[0]
        codes = w["enc_v1"](w["queries"])

        def poisoned(_):
            raise AssertionError("encode stage must be bypassed for codes")

        with S.ServingPipeline(w["enc_v1"], w["search_v1"]) as pipe:
            legacy = pipe.submit(w["queries"]).result()
            typed = pipe.submit(S.SearchRequest(queries=w["queries"])).result()
            short = pipe.submit(S.SearchRequest(queries=w["queries"], k=3)).result()
        with S.ServingPipeline(poisoned, w["search_v1"]) as pipe:
            via_codes = pipe.submit(S.SearchRequest(codes=codes)).result()
        return ref, legacy, typed, short, via_codes

    ref, legacy, typed, short, via_codes = _pair(worlds, scenario)
    for r in (legacy, typed, via_codes):
        assert W.same(r[0], ref[0]) and W.same(r[1], ref[1])
    assert short[0].shape == (BATCH, 3)
    assert W.same(short[1], ref[1][:, :3]) and W.same(short[0], ref[0][:, :3])


# ---------------------------------------------------------------------------
# router-level: version routing, compat fallback, typed dead-end
# ---------------------------------------------------------------------------


def _router(side, pairs, *, compat=None, share_device=False):
    return side.proxy.QueryRouter(side.proxy.ReplicaSet(pairs, share_device=share_device),
                                  compat=compat)


def test_incompatible_version_is_typed_and_terminal(worlds):
    def scenario(side, w):
        router = _router(side, [(w["enc_v1"], w["search_v1"])])
        router.set_version(0, w["ver_v1"])
        try:
            err = W.error_of(router.submit, side.serving.SearchRequest(
                queries=w["queries"], embedding_version="v2"))
            native = router.submit(w["queries"]).result()
        finally:
            router.close()
        return err[0], "v2" in err[1], native

    got = _pair(worlds, scenario)
    assert got[:2] == ("IncompatibleVersion", True)


def test_compat_fallback_bit_identical_with_provenance(worlds):
    def scenario(side, w):
        compat = side.proxy.CompatibilityMatrix()
        compat.register("v2", "v1", w["enc_compat"])
        router = _router(side, [(w["enc_v1"], w["search_v1"])], compat=compat)
        router.set_version(0, w["ver_v1"])
        try:
            res = router.submit(side.serving.SearchRequest(
                queries=w["queries"], embedding_version="v2")).search_result()
            ref = side.serving.serve_sequential(w["enc_compat"], w["search_v1"],
                                                [w["queries"]])[0]
            stats = router.stats()
        finally:
            router.close()
        return ((res.scores, res.ids), ref, _provenance(res), stats["compat_dispatches"],
                stats["per_replica"][0]["embedding_version"], stats["per_replica"][0]["version"])

    got = _pair(worlds, scenario)
    assert W.same(got[0][1], got[1][1])
    assert got[2][:3] == ("v1", 0, True) and got[3] == 1 and got[4] == "v1"


def test_codes_request_cannot_take_compat_hop(worlds):
    def scenario(side, w):
        compat = side.proxy.CompatibilityMatrix()
        compat.register("v2", "v1", w["enc_compat"])
        router = _router(side, [(w["enc_v1"], w["search_v1"])], compat=compat)
        router.set_version(0, w["ver_v1"])
        try:
            return [W.error_of(router.submit, side.serving.SearchRequest(
                codes=w["enc_v2"](w["queries"]), embedding_version="v2"))[0]]
        finally:
            router.close()

    assert _pair(worlds, scenario) == ["IncompatibleVersion"]


def test_native_replica_preferred_over_compat(worlds):
    def scenario(side, w):
        compat = side.proxy.CompatibilityMatrix()
        compat.register("v2", "v1", w["enc_compat"])
        router = _router(side, [(w["enc_v1"], w["search_v1"]), (w["enc_v2"], w["search_v2"])],
                         compat=compat, share_device=True)
        router.set_version(0, w["ver_v1"])
        router.set_version(1, w["ver_v2"])
        out = []
        try:
            for _ in range(4):  # round-robin must not rotate onto compat
                res = router.submit(side.serving.SearchRequest(
                    queries=w["queries"], embedding_version="v2")).search_result()
                out += [(res.scores, res.ids), _provenance(res)]
            out.append(router.stats()["compat_dispatches"])
        finally:
            router.close()
        return out

    got = _pair(worlds, scenario)
    assert got[1][:3] == ("v2", 1, False) and got[-1] == 0


def _broken(codes):
    raise RuntimeError("v2 replica scan fault")


def test_served_by_version_correct_under_failover_mid_upgrade(worlds):
    def scenario(side, w):
        compat = side.proxy.CompatibilityMatrix()
        compat.register("v2", "v1", w["enc_compat"])
        router = _router(side, [(w["enc_v1"], w["search_v1"]), (w["enc_v2"], _broken)],
                         compat=compat, share_device=True)
        router.set_version(0, w["ver_v1"])
        router.set_version(1, w["ver_v2"])
        try:
            res = router.submit(side.serving.SearchRequest(
                queries=w["queries"], embedding_version="v2")).search_result(timeout=30.0)
            ref = side.serving.serve_sequential(w["enc_compat"], w["search_v1"],
                                                [w["queries"]])[0]
        finally:
            router.close()
        return ((res.scores, res.ids), ref, _provenance(res), W.det_stats(router.stats()))

    got = _pair(worlds, scenario)
    assert W.same(got[0][1], got[1][1]) and got[2][:3] == ("v1", 0, True)
    assert got[3]["states"][1] == "unhealthy" and got[3]["failovers"] == 1
    assert got[3]["compat_dispatches"] == 1


def test_failover_dead_end_fails_typed(worlds):
    def scenario(side, w):
        router = _router(side, [(w["enc_v1"], w["search_v1"]), (w["enc_v2"], _broken)],
                         share_device=True)
        router.set_version(0, w["ver_v1"])
        router.set_version(1, w["ver_v2"])
        try:
            t = router.submit(side.serving.SearchRequest(queries=w["queries"],
                                                         embedding_version="v2"))
            return [W.error_of(t.result, timeout=30.0)]
        finally:
            router.close()

    got = _pair(worlds, scenario)
    assert got[0][0] == "IncompatibleVersion"


def test_effort_hint_pre_degrades_knob(worlds):
    def scenario(side, w):
        knob = side.proxy.EffortKnob(n_levels=3)
        router = _router(side, [(w["enc_v1"], w["search_v1"])])
        router.enable_degradation(knob)
        try:
            r = router.submit(side.serving.SearchRequest(queries=w["queries"],
                                                         effort=1)).result()
        finally:
            router.close()
        return r, knob.level, router.stats()["degraded"]

    got = _pair(worlds, scenario)
    assert got[1] >= 1


# ---------------------------------------------------------------------------
# compatibility matrix + registry validation
# ---------------------------------------------------------------------------


def test_compat_matrix_validates_as_the_reference(worlds):
    def scenario(side, w):
        m = side.proxy.CompatibilityMatrix()
        out = [W.error_of(m.register, "v1", "v1", w["enc_v1"]),
               W.error_of(m.register, None, "v1", w["enc_v1"])]
        m.register("v2", "v1", w["enc_compat"])
        out += [m.lookup("v2", "v1") is w["enc_compat"], m.lookup("v1", "v1"),
                m.lookup("v1", "v2"), m.compatible("v2", "v1"), m.compatible("v1", "v1"),
                m.compatible(None, "v1"), m.compatible("v1", "v2"), m.pairs()]
        return out

    got = _pair(worlds, scenario)
    assert got[2:] == [True, None, None, True, True, True, False, [("v2", "v1")]]


def test_make_builder_rejects_unknown_params_as_the_reference():
    for args, kw in ((("flat",), dict(k=5, nprobe=7)), (("no-such-index",), {})):
        got = W.error_of(W.PL.make_builder, *args, **kw)
        assert got == W.error_of(W.RL.make_builder, *args, **kw)
    assert "nprobe" in got[1] or "no-such-index" in got[1]
    err = W.error_of(W.PL.make_builder, "flat", k=5, nprobe=7)
    assert err[0] == "UnknownBuildParam" and "backend" in err[1] and "device" not in err[1]
    assert issubclass(W.PL.UnknownBuildParam, TypeError)
    assert W.PL.make_builder("ivf", k=5, nlist=8, nprobe=4).params["nlist"] == 8


def test_snapshot_first_entry_point_parity(worlds):
    seen = {}
    for side, flat in ((REF, RFL), (PORT, PFL)):
        w = worlds[side.name]
        q = w["enc_v1"](w["queries"])
        kw = {} if side is REF else dict(device="cpu")
        seen[side.name] = [flat.flat_search_from_snapshot(w["snap_v1"], k=K, **kw)(q),
                     W.error_of(flat.flat_search_from_snapshot, w["snap_v1"], LEVELS + 1, k=K,
                                **kw),
                     W.error_of(flat.flat_search_from_snapshot, w["snap_v1"].codes, k=K, **kw)]
    (gv, gi), (rv, ri) = seen["port"][0], seen["ref"][0]
    assert W.same(gv, rv) and W.same(gi, ri)
    assert [e[0] for e in seen["port"][1:]] == [e[0] for e in seen["ref"][1:]] \
        == ["ValueError", "TypeError"]


def test_typed_request_keeps_its_fields():
    req = W.PS.SearchRequest(queries=torch.zeros((3, 2)), embedding_version="v2", k=4)
    assert [f.name for f in dataclasses.fields(req)] == \
        [f.name for f in dataclasses.fields(W.RS.SearchRequest)]
    assert W.PS.as_search_request(req) is req and req.n_queries == 3
