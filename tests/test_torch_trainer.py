"""Binarizer training in the PyTorch port (``repro_torch/core/trainer.py``)
against the JAX reference, then the reference tests' paper claims on the
port's own training.

Parity: the reference's state (its initial one, and one after three of
its steps, so that the queue is partly filled) is carried over with
``train_state_from_numpy``; one ``train_step`` and one ``bc_train_step``
run in both packages on the same batch, and every leaf of the new state
(``train_state_to_numpy``, under the reference's tree keys) is held
against the reference's:

  * the loss terms and the gradient norm: rtol 1e-5;
  * the gradients, through Adam's first moment: from zero moments
    ``mu = (1 - b1) g`` exactly (the gradient norm stays under the clip),
    so ``mu`` and ``nu`` are the gradients before Adam normalises them.
    Every moment leaf within 1e-5 of its own largest entry, except the
    bias that batch norm follows (``in.b``): its gradient is zero in exact
    arithmetic and float32 rounding noise in both packages, so it is held
    to be noise (at most 1e-5 of its MLP's ``in.w`` leaf) and within 1e-5
    of that leaf's largest entry;
  * the parameters after Adam: the reference's update (``train/optim.py``'s
    expression in float32) of the carried-over parameters from the port's
    new moments, within 1e-5 of each leaf's largest entry, and the
    momentum copy its EMA towards them likewise. With the moments held to
    the reference's, this holds the parameters to the reference's as far
    as the gradients determine them, and allows nothing more: where a
    gradient is rounding noise (every ``in.b`` entry), Adam turns it into
    +-lr, and the sign must be the one the port's own moment gives;
  * the running statistics: within 1e-5 of each leaf's largest entry;
  * the queue, its pointer and fill, and the step counts: exactly.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as RC  # noqa: E402
import repro.core.losses as RL  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro_torch import prng  # noqa: E402
import repro_torch.core as PC  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.core import losses as PL  # noqa: E402
from repro_torch.core import trainer as PT  # noqa: E402
from repro_torch.data import synthetic as PS  # noqa: E402
from repro_torch.index.flat import FlatFloat, FlatSDC  # noqa: E402
from repro_torch.launch.lifecycle import (  # noqa: E402
    COMPAT_RECALL_FLOOR,
    CorpusSnapshot,
    make_builder,
)
from repro_torch.train import optim as PO  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test trains: a step is some 2,000 small
    ops, and with the test workers' threads oversubscribing the cores each
    op's parallel region waits on the others (a 10 s test took 270 s under
    six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dim=32, code=16, levels=3, hidden=24, length=128, top_k=8, lr=2e-3, **kw):
    rcfg = RC.TrainConfig(
        binarizer=RC.BinarizerConfig(input_dim=dim, code_dim=code, n_levels=levels,
                                     hidden_dim=hidden),
        queue=RL.QueueConfig(length=length, dim=code, top_k=top_k),
        adam=RO.AdamConfig(lr=lr, clip_norm=5.0), **kw)
    pcfg = PC.TrainConfig(
        binarizer=PC.BinarizerConfig(input_dim=dim, code_dim=code, n_levels=levels,
                                     hidden_dim=hidden),
        queue=PL.QueueConfig(length=length, dim=code, top_k=top_k),
        adam=PO.AdamConfig(lr=lr, clip_norm=5.0), **kw)
    assert repr(rcfg) == repr(pcfg)
    return rcfg, pcfg


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bn_bias(key):
    """Whether ``key`` names a bias that batch norm follows (``in.b``)."""
    return key.endswith("['in']['b']")


def _flat(tree):
    return {jax.tree_util.keystr(path): x
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _adam(p, mu, nu, step, adam):
    """The reference's Adam update of ``p`` from its new moments, float32."""
    assert adam.weight_decay == 0 and adam.schedule is None
    f32 = np.float32
    bc1 = f32(1) - f32(adam.b1) ** f32(step)
    bc2 = f32(1) - f32(adam.b2) ** f32(step)
    return p - f32(adam.lr) * ((mu / bc1) / (np.sqrt(nu / bc2) + f32(adam.eps)))


def _compare(ref_prev, ref_state, port_state, cfg):
    """Hold every leaf of the port's state after one step from
    ``ref_prev`` against the reference's (``ref_state``) under the module
    docstring's rules."""
    prev = _flat(_host(ref_prev))
    ref = jax.tree_util.tree_leaves_with_path(_host(ref_state))
    got = jax.tree_util.tree_leaves_with_path(PT.train_state_to_numpy(port_state))
    assert len(ref) == len(got)
    by_key = {jax.tree_util.keystr(path): x for path, x in ref}
    mine = {jax.tree_util.keystr(path): x for path, x in got}
    step = int(by_key[".opt_state.step"])
    for (rp, x), (pp, y) in zip(ref, got):
        key = jax.tree_util.keystr(rp)
        assert jax.tree_util.keystr(pp) == key
        assert x.shape == y.shape and y.dtype == x.dtype, key
        diff = np.abs(x.astype(np.float64) - y)
        if key.startswith(".queue") or key in (".step", ".opt_state.step"):
            assert not diff.any(), key
        elif key.startswith(".opt_state"):
            scale = float(np.abs(x).max())
            if _bn_bias(key):
                scale = float(np.abs(by_key[key[:-len("['b']")] + "['w']"]).max())
                assert np.abs(x).max() <= TOL * scale, (key, "not rounding noise")
            assert diff.max() <= TOL * max(scale, 1e-30), (key, diff.max())
        elif key.startswith(".params"):
            path = key[len(".params"):]
            want = _adam(prev[key], mine[".opt_state.mu" + path], mine[".opt_state.nu" + path],
                         step, cfg.adam)
            err = np.abs(y.astype(np.float64) - want).max()
            assert err <= TOL * float(np.abs(x).max()), (key, err)
        elif key.startswith(".m_params"):
            want = (np.float32(cfg.ema_decay) * prev[key]
                    + np.float32(1.0 - cfg.ema_decay) * mine[".params" + key[9:]])
            err = np.abs(y.astype(np.float64) - want).max()
            assert err <= TOL * float(np.abs(x).max()), (key, err)
        else:
            assert diff.max() <= TOL * max(float(np.abs(x).max()), 1e-30), (key, diff.max())


def _world(warm):
    """The reference's initial state after ``warm`` of its steps, and the
    next batch."""
    rcfg, pcfg = _cfgs()
    docs, _, _ = RS.clustered_corpus(0, 600, 8, 32)
    gen = RS.pair_batches(docs, 1, 32)
    step = jax.jit(functools.partial(RC.train_step, cfg=rcfg))
    st = RC.init_train_state(jax.random.PRNGKey(0), rcfg)
    for _ in range(warm):
        st, _ = step(st, *next(gen))
    return rcfg, pcfg, docs, st, step, next(gen)


@pytest.mark.parametrize("warm", [0, 3])
def test_train_step_matches_the_reference(warm):
    rcfg, pcfg, _, st, step, (a, p) = _world(warm)
    pst = PT.train_state_from_numpy(_host(st), pcfg, "cpu")
    st2, m = step(st, a, p)
    pst2, pm = PT.train_step(pst, _t(a), _t(p), pcfg)
    assert float(m["grad_norm"]) < rcfg.adam.clip_norm  # mu = (1 - b1) g, unclipped
    assert float(pm["loss"]) == pytest.approx(float(m["loss"]), rel=TOL)
    assert float(pm["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=TOL)
    assert pst2.step == warm + 1 and pst2.opt_state.step == warm + 1
    _compare(st, st2, pst2, rcfg)


@pytest.mark.parametrize("warm", [0, 3])
def test_bc_train_step_matches_the_reference(warm):
    """The reference's warm copy of phi_old (``bc_train_binarizer``) from
    its initial state, one step on both."""
    rcfg, pcfg = _cfgs(temperature=0.2, bc_influence_weight=4.0)
    docs, _, _ = RS.clustered_corpus(1, 600, 8, 32)
    new_docs = RS.backbone_upgrade(docs, 5)
    gen = RS.pair_batches(docs, 2, 32)
    old = RC.init_train_state(jax.random.PRNGKey(3), rcfg)
    step = jax.jit(functools.partial(RC.train_step, cfg=rcfg))
    for _ in range(3):
        old, _ = step(old, *next(gen))
    copy = functools.partial(jax.tree_util.tree_map, jnp.copy)
    st = RC.init_train_state(jax.random.PRNGKey(7), rcfg)._replace(
        params=copy(old.params), m_params=copy(old.params),
        bn_state=copy(old.bn_state), m_bn_state=copy(old.bn_state))
    bc = jax.jit(functools.partial(RC.bc_train_step, cfg=rcfg))
    rng = np.random.default_rng(8)

    def batch():
        idx = rng.integers(0, docs.shape[0], 32)
        a = new_docs[idx] + rng.normal(size=(32, 32)).astype(np.float32) * 0.02
        a /= np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12
        return jnp.asarray(a), jnp.asarray(docs[idx])

    for _ in range(warm):
        st, _ = bc(st, old.params, old.bn_state, *batch())
    pst = PT.train_state_from_numpy(_host(st), pcfg, "cpu")
    pold = PB.binarizer_from_numpy(_host(old.params), _host(old.bn_state), pcfg.binarizer,
                                   device="cpu")
    a, p = batch()
    st2, m = bc(st, old.params, old.bn_state, a, p)
    pst2, pm = PT.bc_train_step(pst, pold, _t(a), _t(p), pcfg)
    for name in ("loss", "loss_self", "loss_bc"):
        assert float(pm[name]) == pytest.approx(float(m[name]), rel=TOL), name
    _compare(st, st2, pst2, rcfg)
    # phi_old is frozen: its weights and statistics did not move
    for x, y in zip(PB.numpy_leaves(pold), jax.tree_util.tree_leaves(_host(
            (old.params, old.bn_state)))):
        np.testing.assert_array_equal(x, y)


def test_train_state_round_trips_and_inits():
    rcfg, pcfg, _, st, step, (a, p) = _world(2)
    tree = _host(st)
    pst = PT.train_state_from_numpy(tree, pcfg, "cpu")
    back = PT.train_state_to_numpy(pst)
    for (kr, x), (kp, y) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype
    fresh = PC.init_train_state(pcfg, prng.key(0, "cpu"), "cpu")
    assert fresh.step == 0 and fresh.opt_state.step == 0
    assert fresh.queue["ptr"] == fresh.queue["filled"] == 0
    assert fresh.queue["buf"].shape == (128, 16)
    leaves = PB.param_leaves(fresh.model)
    assert list(leaves) == list(PB.param_leaves(fresh.m_model)) == list(fresh.opt_state.mu)
    assert len(leaves) == 30  # 5 MLPs x 6 leaves
    for k, v in leaves.items():
        assert torch.equal(v, PB.param_leaves(fresh.m_model)[k])
        assert v.data_ptr() != PB.param_leaves(fresh.m_model)[k].data_ptr()


@pytest.mark.parametrize("docs_dtype", [np.float32, np.float64])
def test_pair_batches_are_the_references_bit_for_bit(docs_dtype):
    docs = RS.clustered_corpus(3, 300, 4, 16)[0].astype(docs_dtype)
    ref, got = RS.pair_batches(docs, 5, 24), PS.pair_batches(docs, 5, 24, device="cpu")
    for _ in range(4):
        (ra, rp), (pa, pp) = next(ref), next(got)
        assert pa.dtype == pp.dtype == torch.float32 and pa.shape == (24, 16)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))


# ---------------------------------------------------------------------------
# The reference tests' paper claims, on the port's own training.
# ---------------------------------------------------------------------------

DIM, CODE = 64, 32


def _train(cfg, docs, steps, seed, batch):
    state = PC.init_train_state(cfg, prng.key(seed, "cpu"), "cpu")
    gen = PS.pair_batches(docs, seed + 1, batch, device="cpu")
    for _ in range(steps):
        state, _ = PC.train_step(state, *next(gen), cfg)
    return state


def _recall(ids, gt, k=10):
    return float(np.mean(np.any(np.asarray(ids)[:, :k] == np.asarray(gt)[:, None], -1)))


def test_end_to_end_recall_claims():
    """``tests/test_system.py::test_bebr_end_to_end_recall`` on the port:
    ours >= the 1-bit hash baseline, ours >= 0.85 x float, and the index
    under an eighth of the float one. Recall over 1,024 queries of the
    test's corpus (its documents do not depend on the query count): the
    reference test's 64 give recall a standard deviation near 0.04, the
    size of the gaps it orders."""
    docs, queries, gt = PS.clustered_corpus(0, 4000, 1024, DIM, n_clusters=128)

    def cfg(levels, steps=300):
        return PC.TrainConfig(
            binarizer=PC.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=levels,
                                         hidden_dim=128),
            queue=PL.QueueConfig(length=1024, dim=CODE, top_k=32),
            adam=PO.AdamConfig(lr=2e-3, clip_norm=5.0,
                               schedule=PO.cosine_schedule(steps, warmup=steps // 10,
                                                           floor=0.05)))

    ff = FlatFloat.build(docs, device="cpu")
    r_float = _recall(ff.search(queries, 10)[1], gt)
    results = {}
    for levels, seed in ((4, 0), (1, 3)):
        state = _train(cfg(levels), docs, 300, seed, 128)
        enc = PB.make_encode_fn(state.model)
        index = FlatSDC.build(enc(docs), levels, device="cpu")
        results[levels] = _recall(index.search(enc(queries), 10)[1], gt), index
    (r_ours, index), (r_hash, _) = results[4], results[1]
    assert r_ours >= r_hash, (r_hash, r_ours, r_float)
    assert r_ours >= 0.85 * r_float, (r_hash, r_ours, r_float)
    assert index.nbytes() < ff.nbytes() / 8


def _compat_cfg():
    return PC.TrainConfig(
        binarizer=PC.BinarizerConfig(input_dim=DIM, code_dim=CODE, n_levels=3, hidden_dim=48),
        queue=PL.QueueConfig(length=512, dim=CODE, top_k=16),
        adam=PO.AdamConfig(lr=1e-3, clip_norm=5.0),
        temperature=0.2, bc_weight=1.0, bc_influence_weight=4.0)


def _recall_cross(q_model, d_model, q_emb, d_emb, gt, k=10):
    bq = PB.binarize_eval(q_model, torch.from_numpy(np.asarray(q_emb, np.float32)))
    bd = PB.binarize_eval(d_model, torch.from_numpy(np.asarray(d_emb, np.float32)))
    idx = torch.sort(PL.cosine(bq, bd), dim=1, descending=True, stable=True).indices[:, :k]
    return _recall(idx, gt, k)


def test_backward_compatible_upgrade_claims():
    """``tests/test_compat.py``'s Table 4 ordering and the serving recall
    floor on the port: BC training through ``serve.bc_train_binarizer``
    (the reference test's loop: warm copy, numpy batches of 128), recall
    over 1,024 queries of the test's corpus."""
    from repro_torch.launch.serve import bc_train_binarizer

    cfg = _compat_cfg()
    docs, queries, gt = PS.clustered_corpus(0, 3000, 1024, DIM, n_clusters=128)
    new_docs = PS.backbone_upgrade(docs, 5)
    new_queries = PS.backbone_upgrade(queries, 5)
    old = _train(cfg, docs, 150, 0, 64).model
    bc = bc_train_binarizer(old, docs, new_docs, cfg, steps=300, batch=128, device="cpu").model
    free = _train(cfg, new_docs, 150, 99, 64).model

    baseline = _recall_cross(old, old, queries, docs, gt)
    incompatible = _recall_cross(free, old, new_queries, docs, gt)
    warm_only = _recall_cross(old, old, new_queries, docs, gt)
    compatible = _recall_cross(bc, old, new_queries, docs, gt)
    assert baseline > 0.8, baseline
    assert incompatible < 0.2, incompatible
    assert compatible > warm_only + 0.05, (warm_only, compatible)
    assert compatible > incompatible + 0.3, (incompatible, compatible)
    assert compatible >= baseline - 0.2, (baseline, compatible)

    # the serving contract: bc queries through the v1 flat index the tier serves
    snap = CorpusSnapshot(codes=PB.make_encode_fn(old)(docs).numpy(), n_levels=3,
                          embedding_version="v1")
    search_v1 = make_builder("flat", k=10, device="cpu").build(snap)
    _, idx = search_v1(PB.make_encode_fn(bc)(new_queries))
    assert _recall(idx, gt) >= COMPAT_RECALL_FLOOR
