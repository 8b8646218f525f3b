"""The dlrm-rm2 serving forward of the PyTorch port against the JAX reference.

On CPU tensors the port's ``dot_interact`` runs its plain version
(``dot_interact_torch``: a sum over d in index order, one product and one
add at a time). The reference sums in another order (a batched product),
so the two agree within the float32 bound of two D-term sums,
2 * gamma_D * sum_d |e_id e_jd| with gamma_D = D u / (1 - D u), u = 2^-24,
which ``_tol`` computes element by element. The ``SMOKE`` forward, with
the reference's weights carried over by ``dlrm_from_numpy`` and fed the
reference's ``dlrm_batch`` arrays, agrees within 1e-5 (absolute and
relative): its float32 products (widths up to 367) are summed in other
orders by XLA and by torch. The CUDA kernel is held against the plain
version, exactly, by the ``gpu`` tests (on the card only) and by
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import dlrm_rm2 as RC  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro.kernels.dot_interact import ops as RO  # noqa: E402
from repro.kernels.dot_interact import ref as RR  # noqa: E402
from repro.models.recsys import dlrm as RD  # noqa: E402
from repro.models.recsys import embedding as RE  # noqa: E402
from repro_torch.configs.archs import dlrm_rm2 as PC  # noqa: E402
from repro_torch.data import synthetic as PS  # noqa: E402
from repro_torch.kernels.dot_interact import kernel as PK  # noqa: E402
from repro_torch.kernels.dot_interact import ops as PO  # noqa: E402
from repro_torch.kernels.dot_interact import ref as PR  # noqa: E402
from repro_torch.models.recsys import dlrm as PD  # noqa: E402
from repro_torch.models.recsys import embedding as PE  # noqa: E402
from repro_torch.train.steps import dlrm_serve_step  # noqa: E402

LOGIT_TOL = 1e-5
# (B, F, D): dlrm-rm2's interaction at a ragged B, SMOKE's, small shapes, and
# the kernel's edges: F of 2, 5 and 40 (row blocks of 4 cut at the diagonal),
# D of 13 and 65 (not a multiple of 4: zero padding).
SHAPES = [(37, 27, 64), (130, 27, 16), (5, 3, 7), (1, 2, 1), (19, 8, 33), (9, 2, 13),
          (17, 5, 65), (6, 40, 13), (33, 27, 13), (10, 40, 64)]


def _emb(B, F, D, seed=0):
    return np.random.default_rng(seed + B * F * D).standard_normal((B, F, D)).astype(np.float32)


def _tol(e):
    """Elementwise bound on the difference of two float32 D-term dot sums."""
    B, F, D = e.shape
    u = 2.0**-24
    gamma = D * u / (1 - D * u)
    r, c = np.tril_indices(F, -1)
    a = np.abs(e.astype(np.float64))
    return 2 * gamma * np.einsum("bpd,bpd->bp", a[:, r], a[:, c])


def test_tril_indices_match_reference():
    for F in (2, 5, 27):
        rr, rc = RR.tril_indices(F)
        pr, pc = PR.tril_indices(F)
        assert np.array_equal(np.asarray(rr), pr.numpy())
        assert np.array_equal(np.asarray(rc), pc.numpy())


@pytest.mark.parametrize("B,F,D", SHAPES)
def test_dot_interact_matches_reference(B, F, D):
    e = _emb(B, F, D)
    before = PK.dot_interact.launches
    got = PK.dot_interact(torch.from_numpy(e))
    assert PK.dot_interact.launches == before  # the CPU path launches no kernel
    assert got.dtype == torch.float32 and got.shape == (B, F * (F - 1) // 2)
    interp = np.asarray(RO.dot_interaction(jnp.asarray(e), block_b=16, interpret=True))
    oracle = np.asarray(RR.dot_interact_ref(jnp.asarray(e)))
    tol = _tol(e)
    assert (np.abs(got.numpy() - interp) <= tol).all()
    assert (np.abs(got.numpy() - oracle) <= tol).all()
    # the port's own Gram formulation, and the ops wrapper
    assert (np.abs(PR.dot_interact_ref(torch.from_numpy(e)).numpy() - oracle) <= tol).all()
    assert torch.equal(PO.dot_interaction(torch.from_numpy(e)), got)


def test_plain_version_sums_in_index_order():
    """dot_interact_torch is the in-order float32 sum of separately rounded products."""
    e = _emb(6, 5, 9)
    got = PR.dot_interact_torch(torch.from_numpy(e)).numpy()
    r, c = np.tril_indices(5, -1)
    want = np.zeros((6, len(r)), np.float32)
    for d in range(9):
        want = want + e[:, r, d] * e[:, c, d]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_dot_interact_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        PK.dot_interact(torch.zeros((2, 3, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        PK.dot_interact(torch.zeros((2, 1, 4)))
    with pytest.raises(ValueError):
        PK.dot_interact(torch.zeros((2, 12)))


def test_configs_are_the_reference_configs():
    for name in ("CONFIG", "SMOKE"):
        ref, got = getattr(RC, name), getattr(PC, name)
        fields = {f.name for f in dataclasses.fields(ref)} - {"dtype"}
        assert {f: getattr(got, f) for f in fields} == {f: getattr(ref, f) for f in fields}
        assert got.dtype == torch.float32
        assert (got.n_feat, got.interact_dim, got.param_count()) == \
            (ref.n_feat, ref.interact_dim, ref.param_count())
    assert PC.CONFIG.table_vocab == 1_048_576 and PC.CONFIG.interact_dim == 351 + 64


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_mlp_and_lookup_match_reference():
    key = jax.random.PRNGKey(3)
    layers = RE.mlp_params(key, (13, 64, 32, 16))
    x = np.random.default_rng(0).standard_normal((9, 13)).astype(np.float32)
    ref = np.asarray(RE.mlp_apply(layers, jnp.asarray(x)))
    torch_layers = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
                    for layer in layers]
    got = PE.mlp_apply(torch_layers, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    table = np.array(RE.init_table(key, RE.TableConfig(50, 8)))
    ids = np.array([[0, 49, 3], [7, 7, 1]], np.int32)
    got = PE.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    assert np.array_equal(got.numpy(), np.asarray(RE.embedding_lookup(table, ids)))


@pytest.mark.parametrize("step,batch", [(0, 64), (3, 37)])
def test_smoke_forward_matches_reference(step, batch):
    cfg_r, cfg_p = RC.SMOKE, PC.SMOKE
    params = RD.init_params(jax.random.PRNGKey(step), cfg_r)
    model = PD.dlrm_from_numpy(_numpy_tree(params), cfg_p, device="cpu")
    b = RS.dlrm_batch(step, batch, cfg_r)
    ref = np.asarray(RD.forward(params, b["dense"], b["sparse_ids"], cfg_r))
    ref_kernel = np.asarray(RD.forward(
        params, b["dense"], b["sparse_ids"], cfg_r,
        interact_fn=lambda f: RO.dot_interaction(f, block_b=16, interpret=True)))
    step_fn = dlrm_serve_step(cfg_p)
    b = {k: np.array(v) for k, v in b.items()}
    got = step_fn(model, b)
    assert got.shape == (batch,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), ref_kernel, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # the reference's Gram formulation in the port gives the same logits within the bound
    plain = model(b["dense"], b["sparse_ids"], interact_fn=PR.dot_interact_ref)
    np.testing.assert_allclose(plain.detach().numpy(), ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # the features the interaction sees: [x, emb], as in the reference
    x, feats = model.features(b["dense"], b["sparse_ids"])
    assert feats.shape == (batch, cfg_p.n_feat, cfg_p.embed_dim)
    assert torch.equal(feats[:, 0], x)
    tables = np.asarray(params["tables"])
    ids = b["sparse_ids"]
    assert np.array_equal(feats[:, 1:].detach().numpy(),
                          tables[np.arange(cfg_p.n_sparse)[None, :], ids])


def test_serve_step_refuses_another_config():
    model = PD.init_dlrm(PC.SMOKE, torch.Generator().manual_seed(0), device="cpu")
    other = dataclasses.replace(PC.SMOKE, name="other")
    batch = PS.dlrm_batch(0, 4, PC.SMOKE, device="cpu")
    with pytest.raises(ValueError):
        dlrm_serve_step(other)(model, batch)


def test_init_dlrm_draws_the_reference_distributions():
    cfg = dataclasses.replace(PC.SMOKE, table_vocab=4000)
    model = PD.init_dlrm(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert model.tables.shape == (26, 4000, 16)
    tables = model.tables.detach()
    assert abs(float(tables.std()) - 16**-0.5) < 0.01
    assert abs(float(tables.mean())) < 0.01
    dims = cfg.bot_mlp
    for layer, a, b in zip(model.bot, dims[:-1], dims[1:]):
        assert layer["w"].shape == (a, b) and not layer["b"].any()
    assert [tuple(layer["w"].shape) for layer in model.top] == \
        list(zip(cfg.top_dims[:-1], cfg.top_dims[1:]))
    w = model.top[0]["w"].detach()
    assert abs(float(w.std()) - (2 / cfg.interact_dim) ** 0.5) < 0.01
    batch = PS.dlrm_batch(0, 33, cfg, device="cpu")
    logits = dlrm_serve_step(cfg)(model, batch)
    assert logits.shape == (33,) and bool(torch.isfinite(logits).all())


def test_dlrm_batch_is_a_function_of_the_step():
    cfg = PC.SMOKE
    a = PS.dlrm_batch(5, 300, cfg, device="cpu")
    b = PS.dlrm_batch(5, 300, cfg, device="cpu")
    c = PS.dlrm_batch(6, 300, cfg, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dense"], c["dense"])
    assert a["dense"].shape == (300, 13) and a["dense"].dtype == torch.float32
    ids = a["sparse_ids"]
    assert ids.shape == (300, 26) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < cfg.table_vocab
    assert set(a["labels"].unique().tolist()) <= {0.0, 1.0}
    assert 0.15 < float(a["labels"].mean()) < 0.35


def test_dlrm_from_numpy_checks_shapes():
    params = _numpy_tree(RD.init_params(jax.random.PRNGKey(0), RC.SMOKE))
    bad = dict(params, bot=params["bot"][:-1])
    with pytest.raises(ValueError):
        PD.dlrm_from_numpy(bad, PC.SMOKE, device="cpu")
    with pytest.raises(ValueError):
        PD.dlrm_from_numpy(params, PC.CONFIG, device="cpu")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,F,D", [(512, 27, 64), (1001, 27, 64), (7, 3, 5), (33, 40, 33),
                                   (5, 50, 8), (130, 27, 16), (9, 2, 13), (17, 5, 65),
                                   (33, 40, 13), (1, 27, 64), (4099, 27, 64), (1001, 27, 65),
                                   (4097, 5, 13), (600, 27, 300), (300, 27, 600),
                                   (2, 27, 1100)])
def test_kernel_matches_plain_on_card(B, F, D):
    dev = _card()
    e = torch.randn((B, F, D), generator=torch.Generator(device=dev).manual_seed(B), device=dev)
    before = PK.dot_interact.launches
    got = PK.dot_interact(e)
    torch.cuda.synchronize()
    assert PK.dot_interact.launches == before + 1
    assert torch.equal(got, PR.dot_interact_torch(e))
    assert torch.equal(got.cpu(), PR.dot_interact_torch(e.cpu()))


@pytest.mark.gpu
def test_smoke_forward_on_card_never_reaches_the_plain_version(monkeypatch):
    dev = _card()

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(PK, "dot_interact_torch", plain)
    params = _numpy_tree(RD.init_params(jax.random.PRNGKey(0), RC.SMOKE))
    model = PD.dlrm_from_numpy(params, PC.SMOKE)
    assert model.tables.device.type == dev.type
    batch = PS.dlrm_batch(0, 129, PC.SMOKE)
    before = PK.dot_interact.launches
    logits = dlrm_serve_step(PC.SMOKE)(model, batch)
    torch.cuda.synchronize()
    assert PK.dot_interact.launches == before + 1
    cpu = PD.dlrm_from_numpy(params, PC.SMOKE, device="cpu")
    want = cpu(batch["dense"].cpu(), batch["sparse_ids"].cpu(), interact_fn=PR.dot_interact_ref)
    np.testing.assert_allclose(logits.cpu().numpy(), want.detach().numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
