"""The recsys zoo's models in the PyTorch port against the JAX reference.

Every comparison starts from the reference's weights (its ``init_params``
at the SMOKE configs, carried over by ``*_from_numpy``) and its batches
(``data/synthetic.py``'s ``jax.random`` draws, handed over as arrays).

Tolerances:
  * ``embedding_bag``, ``embedding_bag_fixed`` and ``hash_bucket``:
    exactly (the same gathers and the same sums in the same order;
    integer arithmetic for the hash);
  * every forward, loss and serve output: within 1e-5 relative to the
    output's largest entry (float32 products summed in other orders by
    XLA and by torch, and XLA's CPU ``rsqrt``, which is not correctly
    rounded, in two-tower's ``_unit`` and MIND's ``_squash``);
  * the ``dot_interact`` gradient: ``torch.autograd.gradcheck`` in float64
    (the backward against finite differences of the plain version), equal
    to autograd through ``dot_interact_torch`` within 1e-12 in float64,
    and within the float32 bound of a 2(F-1)-term sum in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import dien_cfg as RDC  # noqa: E402
from repro.configs.archs import dlrm_rm2 as RDL  # noqa: E402
from repro.configs.archs import mind_cfg as RMC  # noqa: E402
from repro.configs.archs import two_tower as RTC  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro.models.recsys import dien as RDI  # noqa: E402
from repro.models.recsys import dlrm as RD  # noqa: E402
from repro.models.recsys import embedding as RE  # noqa: E402
from repro.models.recsys import mind as RM  # noqa: E402
from repro.models.recsys import two_tower as RT  # noqa: E402
from repro_torch.configs.archs import dien_cfg as PDC  # noqa: E402
from repro_torch.configs.archs import dlrm_rm2 as PDL  # noqa: E402
from repro_torch.configs.archs import mind_cfg as PMC  # noqa: E402
from repro_torch.configs.archs import two_tower as PTC  # noqa: E402
from repro_torch.configs import registry as PREG  # noqa: E402
from repro_torch.kernels.dot_interact import ops as PDO  # noqa: E402
from repro_torch.kernels.dot_interact import ref as PDR  # noqa: E402
from repro_torch.models.recsys import dien as PDI  # noqa: E402
from repro_torch.models.recsys import dlrm as PD  # noqa: E402
from repro_torch.models.recsys import embedding as PE  # noqa: E402
from repro_torch.models.recsys import mind as PM  # noqa: E402
from repro_torch.models.recsys import two_tower as PT  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models are many small ops, which the test
    workers' threads would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in _np(batch).items()}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= tol, f"max |port - reference| / max |reference| = {err:.3g} > {tol}"


def _ref_params(mod, cfg, seed=0):
    return _np(mod.init_params(jax.random.PRNGKey(seed), cfg))


# ---------------------------------------------------------------------------
# Embeddings.
# ---------------------------------------------------------------------------


def _table(v=50, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((v, d)).astype(np.float32)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_exact(combiner, weighted):
    rng = np.random.default_rng(1)
    table = _table()
    ids = rng.integers(0, 50, 40).astype(np.int32)
    seg = rng.integers(0, 7, 40).astype(np.int32)  # unsorted, bag 7 of 8 empty
    seg[seg == 6] = 5
    w = rng.standard_normal(40).astype(np.float32) if weighted else None
    want = RE.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 8,
                            weights=None if w is None else jnp.asarray(w), combiner=combiner)
    got = PE.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(seg), 8,
                           weights=None if w is None else torch.from_numpy(w),
                           combiner=combiner)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_fixed_exact(combiner, masked):
    rng = np.random.default_rng(2)
    table = _table(seed=3)
    ids = rng.integers(0, 50, (6, 11)).astype(np.int32)
    mask = (rng.random((6, 11)) < 0.7).astype(np.float32) if masked else None
    if masked:
        mask[2] = 0  # an empty bag: the mean's denominator clamps to 1
    want = RE.embedding_bag_fixed(jnp.asarray(table), jnp.asarray(ids),
                                  None if mask is None else jnp.asarray(mask), combiner)
    got = PE.embedding_bag_fixed(torch.from_numpy(table), torch.from_numpy(ids),
                                 None if mask is None else torch.from_numpy(mask), combiner)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("vocab", [1, 1000, 2_097_152, 2**31 - 1])
def test_hash_bucket_exact(vocab):
    rng = np.random.default_rng(4)
    ids = np.concatenate([rng.integers(-2**31, 2**31 - 1, 500),
                          [0, 1, -1, 2**31 - 1, -2**31, 65535, 65536]]).astype(np.int32)
    want = np.asarray(RE.hash_bucket(jnp.asarray(ids), vocab))
    got = PE.hash_bucket(torch.from_numpy(ids), vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lookup_gradient_sums_repeated_ids():
    """``embedding_lookup``'s backward (index_put_ with accumulate) sums the rows
    of a repeated id, as the reference's gradient of ``jnp.take`` does."""
    table = _table(v=10, d=4)
    ids = np.array([[3, 3, 1], [3, 0, 1]], np.int32)
    g = np.random.default_rng(5).standard_normal((2, 3, 4)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jnp.take(t, jnp.asarray(ids), axis=0) * g))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    (PE.embedding_lookup(t, torch.from_numpy(ids)) * torch.from_numpy(g)).sum().backward()
    _close(t.grad, want, 1e-7)


def test_mlp_apply_final_act():
    rng = np.random.default_rng(6)
    layers = _np(RE.mlp_params(jax.random.PRNGKey(1), (5, 7, 3)))
    x = rng.standard_normal((4, 5)).astype(np.float32)
    want = RE.mlp_apply(layers, jnp.asarray(x), final_act=jax.nn.sigmoid)
    got = PE.mlp_apply(PE.tree_from_numpy(layers, device="cpu"), torch.from_numpy(x),
                       final_act=torch.sigmoid)
    _close(got, want)


def test_tree_round_trip():
    params = _ref_params(RT, RTC.SMOKE)
    back = PT.two_tower_to_numpy(PT.two_tower_from_numpy(params, PTC.SMOKE, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The dot_interact autograd function.
# ---------------------------------------------------------------------------


class _Plain64(torch.autograd.Function):
    """The port's function with its plain forward, so that it takes float64."""

    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return PDR.dot_interact_torch(emb)

    @staticmethod
    def backward(ctx, grad):
        return PDO.dot_interact_backward(ctx.saved_tensors[0], grad)


@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 2, 1), (4, 7, 3)])
def test_dot_interact_backward_gradcheck(shape):
    e = torch.randn(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    assert torch.autograd.gradcheck(_Plain64.apply, (e,))
    g = torch.randn((shape[0], shape[1] * (shape[1] - 1) // 2), dtype=torch.float64)
    (want,) = torch.autograd.grad(PDR.dot_interact_torch(e), e, g)
    got = PDO.dot_interact_backward(e.detach(), g)
    assert float((got - want).abs().max()) <= 1e-12


@pytest.mark.parametrize("shape", [(37, 27, 16), (5, 3, 7)])
def test_dot_interaction_gradient_float32(shape):
    rng = np.random.default_rng(7)
    e = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((shape[0], shape[1] * (shape[1] - 1) // 2)).astype(np.float32)
    x = torch.from_numpy(e).requires_grad_(True)
    out = PDO.dot_interaction(x)
    assert torch.equal(out, PDR.dot_interact_torch(torch.from_numpy(e)))
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    assert torch.equal(got, PDO.dot_interact_backward(torch.from_numpy(e), torch.from_numpy(g)))
    # the reference's gradient: JAX differentiating dot_interact_ref
    from repro.kernels.dot_interact.ref import dot_interact_ref

    want = jax.vjp(dot_interact_ref, jnp.asarray(e))[1](jnp.asarray(g))[0]
    F = shape[1]
    bound = 2 * (F - 1) * 2.0**-24 * float(np.abs(g).max()) * float(np.abs(e).max()) * (
        2 * (F - 1)) + 1e-6
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= bound


# ---------------------------------------------------------------------------
# The four models at SMOKE.
# ---------------------------------------------------------------------------


def test_dlrm_forward_and_loss():
    cfg_r, cfg_p = RDL.SMOKE, PDL.SMOKE
    params = _ref_params(RD, cfg_r)
    batch = RS.dlrm_batch(3, 16, cfg_r)
    tree = PD.dlrm_from_numpy(params, cfg_p, "cpu").tree()
    b = _t(batch)
    _close(PD.forward(tree, b["dense"], b["sparse_ids"], cfg_p),
           RD.forward(params, batch["dense"], batch["sparse_ids"], cfg_r))
    _close(PD.bce_loss(tree, b["dense"], b["sparse_ids"], b["labels"], cfg_p),
           RD.bce_loss(params, batch["dense"], batch["sparse_ids"], batch["labels"], cfg_r))
    back = PD.dlrm_to_numpy(PD.DLRM.from_tree(tree, cfg_p))
    np.testing.assert_array_equal(back["tables"], params["tables"])


def test_two_tower_embeds_loss_and_scores():
    cfg_r, cfg_p = RTC.SMOKE, PTC.SMOKE
    params = _ref_params(RT, cfg_r)
    batch = RS.tt_batch(2, 16, cfg_r)
    batch["hist_mask"] = jnp.asarray(
        np.random.default_rng(8).random((16, cfg_r.hist_len)) < 0.8, jnp.float32)
    tree = PT.two_tower_from_numpy(params, cfg_p, "cpu")
    b = _t(batch)
    logq = np.random.default_rng(9).standard_normal(16).astype(np.float32) * 0.1
    _close(PT.query_embed(tree, b["hist_ids"], b["hist_mask"], cfg_p),
           RT.query_embed(params, batch["hist_ids"], batch["hist_mask"], cfg_r))
    _close(PT.item_embed(tree, b["pos_items"], cfg_p),
           RT.item_embed(params, batch["pos_items"], cfg_r))
    _close(PT.sampled_softmax_loss(tree, b["hist_ids"], b["hist_mask"], b["pos_items"],
                                   torch.from_numpy(logq), cfg_p),
           RT.sampled_softmax_loss(params, batch["hist_ids"], batch["hist_mask"],
                                   batch["pos_items"], jnp.asarray(logq), cfg_r))
    cand = np.arange(0, 1000, 7, dtype=np.int32)
    _close(PT.score_candidates(tree, b["hist_ids"], b["hist_mask"], torch.from_numpy(cand),
                               cfg_p),
           RT.score_candidates(params, batch["hist_ids"], batch["hist_mask"],
                               jnp.asarray(cand), cfg_r))


@pytest.mark.parametrize("routing_init", [False, True])
def test_mind_capsules_and_loss(routing_init):
    cfg_r, cfg_p = RMC.SMOKE, PMC.SMOKE
    params = _ref_params(RM, cfg_r)
    batch = RS.mind_batch(5, 12, cfg_r)
    rng = np.random.default_rng(10)
    batch["hist_mask"] = jnp.asarray(rng.random((12, cfg_r.hist_len)) < 0.8, jnp.float32)
    init = (rng.standard_normal((12, cfg_r.n_interests, cfg_r.hist_len)).astype(np.float32)
            if routing_init else None)
    tree = PM.mind_from_numpy(params, cfg_p, "cpu")
    b = _t(batch)
    _close(PM.interest_capsules(tree, b["hist_ids"], b["hist_mask"], cfg_p,
                                None if init is None else torch.from_numpy(init)),
           RM.interest_capsules(params, batch["hist_ids"], batch["hist_mask"], cfg_r,
                                None if init is None else jnp.asarray(init)))
    _close(PM.label_aware_loss(tree, b["hist_ids"], b["hist_mask"], b["pos_items"],
                               b["neg_items"], cfg_p),
           RM.label_aware_loss(params, batch["hist_ids"], batch["hist_mask"],
                               batch["pos_items"], batch["neg_items"], cfg_r))
    _close(PM.serve_interests(tree, b["hist_ids"], b["hist_mask"], cfg_p),
           RM.serve_interests(params, batch["hist_ids"], batch["hist_mask"], cfg_r))


def test_dien_forward_and_loss():
    cfg_r, cfg_p = RDC.SMOKE, PDC.SMOKE
    params = _ref_params(RDI, cfg_r)
    batch = RS.dien_batch(4, 10, cfg_r)
    mask = np.ones((10, cfg_r.seq_len), np.float32)
    mask[:, 15:] = 0  # padded tails, and one row with no behaviors
    mask[3] = 0
    batch["hist_mask"] = jnp.asarray(mask)
    tree = PDI.dien_from_numpy(params, cfg_p, "cpu")
    b = _t(batch)
    args = ("hist_items", "hist_cates", "hist_mask", "target_item", "target_cate")
    _close(PDI.forward(tree, *(b[a] for a in args), cfg_p),
           RDI.forward(params, *(batch[a] for a in args), cfg_r))
    _close(PDI.bce_loss(tree, *(b[a] for a in args), b["labels"], cfg_p),
           RDI.bce_loss(params, *(batch[a] for a in args), batch["labels"], cfg_r))


@pytest.mark.parametrize("arch", ["dlrm-rm2", "two-tower-retrieval", "mind", "dien"])
def test_configs_match_the_reference(arch):
    from repro.configs.archs import dien_cfg, dlrm_rm2, mind_cfg, two_tower

    ref = {"dlrm-rm2": dlrm_rm2, "two-tower-retrieval": two_tower, "mind": mind_cfg,
           "dien": dien_cfg}[arch]
    entry = PREG.get_arch(arch)
    assert entry.family == "recsys"
    for got, want in ((entry.config, ref.CONFIG), (entry.smoke_config, ref.SMOKE)):
        for field in type(want).__dataclass_fields__:
            if field != "dtype":
                assert getattr(got, field) == getattr(want, field), field
        assert got.param_count() == want.param_count()


@pytest.mark.parametrize("arch,family", [
    ("llama3-405b", "lm"), ("llama3.2-1b", "lm"), ("mistral-large-123b", "lm"),
    ("llama4-scout-17b-a16e", "lm"), ("grok-1-314b", "lm"), ("meshgraphnet", "gnn")])
def test_lm_and_gnn_ids_resolve(arch, family):
    """The LM and GNN ids resolve to their family and to configs equal to
    the reference's field for field (dtypes by name), with equal parameter
    counts and shape ids."""
    from repro.configs.registry import REGISTRY

    ref, entry = REGISTRY[arch], PREG.get_arch(arch)
    assert entry.family == ref.family == family and entry.shapes == ref.shapes
    for got, want in ((entry.config, ref.config), (entry.smoke_config, ref.smoke_config)):
        for field in type(want).__dataclass_fields__:
            g, w = getattr(got, field), getattr(want, field)
            if field in ("dtype", "kv_cache_dtype"):
                g, w = str(g).split(".")[-1], np.dtype(w).name
            assert g == w, field
        assert got.param_count() == want.param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        PREG.get_arch("no-such-arch")


def test_registry_covers_the_reference():
    from repro.configs.registry import REGISTRY

    assert list(PREG.REGISTRY) == list(REGISTRY)
    for arch, entry in REGISTRY.items():
        assert PREG.REGISTRY[arch].family == entry.family
        assert PREG.REGISTRY[arch].shapes == entry.shapes
