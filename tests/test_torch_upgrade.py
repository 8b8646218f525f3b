"""The live embedding-version upgrade of the port's CLI (``--upgrade-after``):
``serve.bc_train_binarizer`` and ``serve._next_version`` against the
reference's, and the upgrade driven through ``serve.serve_routed`` on the
CPU (compat encoders both ways, a rolling swap to the next version's
snapshot under mixed-version traffic).

``bc_train_binarizer`` draws the reference's numpy batches from the same
seed and warm-starts from ``old`` as the reference does; one step is held
against the reference's within ``test_torch_trainer``'s tolerances.
"""

import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as RC  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.data import synthetic as PS  # noqa: E402
from repro_torch.launch import lifecycle, proxy, serve, serving  # noqa: E402

from test_torch_trainer import _cfgs, _compare, _host, _one_thread  # noqa: E402,F401


@pytest.mark.parametrize("tag", ["v1", "v9", "v10", "prod", "v1a", "v", "V2"])
def test_next_version_matches_the_reference(tag):
    assert serve._next_version(tag) == rserve._next_version(tag)


def test_bc_train_binarizer_matches_the_reference():
    rcfg, pcfg = _cfgs(temperature=0.2, bc_influence_weight=4.0)
    docs, _, _ = RS.clustered_corpus(2, 600, 8, 32)
    new_docs = RS.backbone_upgrade(docs, 5)
    old = RC.init_train_state(jax.random.PRNGKey(4), rcfg)
    step = jax.jit(lambda s, a, p: RC.train_step(s, a, p, rcfg))
    gen = RS.pair_batches(docs, 3, 32)
    for _ in range(3):
        old, _ = step(old, *next(gen))
    ref = rserve.bc_train_binarizer(types.SimpleNamespace(params=old.params,
                                                          bn_state=old.bn_state),
                                    docs, new_docs, rcfg, steps=1, batch=32)
    pold = PB.binarizer_from_numpy(_host(old.params), _host(old.bn_state), pcfg.binarizer,
                                   device="cpu")
    before = PB.numpy_leaves(pold)
    got = serve.bc_train_binarizer(pold, docs, new_docs, pcfg, steps=1, batch=32, device="cpu")
    # the state the reference's bc_train_binarizer (seed 7) starts from
    start = RC.init_train_state(jax.random.PRNGKey(7), rcfg)._replace(
        params=old.params, m_params=old.params)
    _compare(start, ref, got, rcfg)
    for x, y in zip(before, PB.numpy_leaves(pold)):
        np.testing.assert_array_equal(x, y)  # phi_old untouched
    assert got.model is not pold and got.m_model is not pold


def test_upgrade_through_the_routed_tier():
    """Two replicas serve v1; the v2 binarizer is bc-trained, compat
    encoders are registered both ways, and the tier swaps to v2's snapshot
    mid-stream. Nothing is lost, every answer is one the (encoder, index)
    pairs of its version can give, compat dispatches happen, and both
    replicas end on v2."""
    tcfg = serve.cli_train_config(32, 16, 3)
    docs, queries, gt = PS.clustered_corpus(0, 1500, 32, 32)
    old = serve.init_train_state(tcfg, prng.key(0, "cpu"), "cpu").model
    new_docs = PS.backbone_upgrade(docs, 5)
    new_queries = PS.backbone_upgrade(queries, 5)
    new = serve.bc_train_binarizer(old, docs, new_docs, tcfg, steps=5, batch=64,
                                   device="cpu").model
    enc_old, enc_new = PB.make_encode_fn(old), PB.make_encode_fn(new)
    builder = serve.cli_builder("flat", k=10, device="cpu")
    snap_v1 = lifecycle.CorpusSnapshot(codes=serve.encode_codes(old, docs).numpy(), n_levels=3,
                                       embedding_version="v1")
    snap_v2 = lifecycle.CorpusSnapshot(codes=serve.encode_codes(new, new_docs).numpy(),
                                       n_levels=3, embedding_version="v2")
    search_v1, search_v2 = builder.build(snap_v1), builder.build(snap_v2)
    compat = proxy.CompatibilityMatrix()
    compat.register("v2", "v1", enc_new)
    compat.register("v1", "v2", enc_old)
    batches = [queries[i:i + 8] for i in range(0, 32, 8)]
    new_batches = [new_queries[i:i + 8] for i in range(0, 32, 8)]
    stream, meta = [], []
    for _ in range(3):
        for b, nb in zip(batches, new_batches):
            stream += [serving.SearchRequest(queries=b, embedding_version="v1"),
                       serving.SearchRequest(queries=nb, embedding_version="v2")]
            meta += [("v1", b), ("v2", nb)]
    serving.warmup(enc_old, search_v1, batches)
    run = serve.serve_routed(enc_old, search_v1, stream, warm_batches=batches, replicas=2,
                             builder=builder, snapshot=snap_v2, swap_after=6, compat=compat,
                             swap_encode=enc_new, embedding_version="v1", device="cpu")
    assert len(run.results) == len(stream) and all(r is not None for r in run.results)
    for (ver, q), (v, i) in zip(meta, run.results):
        enc = enc_old if ver == "v1" else enc_new
        answers = [search(enc(q)) for search in (search_v1, search_v2)]
        assert any(torch.equal(v, av) and torch.equal(i, ai) for av, ai in answers), ver
    st = run.stats
    assert st["compat_dispatches"] >= 1
    assert [r["embedding_version"] for r in st["per_replica"]] == ["v2", "v2"]
    assert run.swap is not None and run.swap.swapped == 2 and run.swap.version.tag.startswith(
        "flat:v2:")
