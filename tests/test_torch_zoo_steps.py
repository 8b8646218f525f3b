"""The recsys zoo's train, serve and retrieval steps in the PyTorch port
(``repro_torch/train/steps.py``) against the JAX reference, at the SMOKE
configs, from the reference's weights and batches.

Train steps, one from the reference's initial parameters and zero Adam
moments, with the launcher's Adam (lr 3e-4, clipped at global norm 1.0):
  * the loss and the gradient norm: rtol 1e-5;
  * the gradients (``_accumulate_grads``, before clipping) and Adam's new
    moments, leaf by leaf: within 1e-4 of each leaf's largest entry (as
    ``tests/test_torch_trainer.py`` holds the binarizer's; the tables'
    rows sum repeated ids, and XLA and torch sum the products of each
    backward in other orders);
  * the parameters after Adam: the reference's update (float32) of the
    initial parameters from the port's own new moments, within 1e-5 of
    each leaf's largest entry, so a parameter is held as far as its
    gradient determines it (where a gradient is rounding noise Adam turns
    it into +-lr either way);
  * the same with ``microbatches=2`` (the reference's accumulation
    order), and the gradients alone with ``microbatches`` of 1 and 3;
  * DIEN's last attention bias, whose gradient is rounding noise (see
    NOISE_LEAVES), against its weight's largest entry.
Serve outputs: within 1e-5 relative to their largest entry. Retrieval
ids: exactly, ties toward the lower id (duplicated candidates make exact
ties); scores within 1e-5 relative. ``tt_retrieval_bebr_step`` with the
candidate codes and inverse norms handed over: the same top-k ids, the
scores within 1e-6 relative, also where inverse norms are 0 or negative
(those candidates compete, as in the reference).
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
from repro.kernels.sdc import ref as RSR  # noqa: E402
from repro.models.recsys import dien as RDI  # noqa: E402
from repro.models.recsys import dlrm as RD  # noqa: E402
from repro.models.recsys import mind as RM  # noqa: E402
from repro.models.recsys import two_tower as RT  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro.train import steps as RST  # noqa: E402
from repro_torch.configs.archs import dien_cfg as PDC  # noqa: E402
from repro_torch.configs.archs import dlrm_rm2 as PDL  # noqa: E402
from repro_torch.configs.archs import mind_cfg as PMC  # noqa: E402
from repro_torch.configs.archs import two_tower as PTC  # noqa: E402
from repro_torch.models.recsys import dien as PDI  # noqa: E402
from repro_torch.models.recsys import dlrm as PD  # noqa: E402
from repro_torch.models.recsys import embedding as PE  # noqa: E402
from repro_torch.train import optim as PO  # noqa: E402
from repro_torch.train import steps as PST  # noqa: E402
from repro_torch.train.checkpoint import flatten_tree  # noqa: E402

LOSS_TOL, GRAD_TOL, PARAM_TOL, SERVE_TOL = 1e-5, 1e-4, 1e-5, 1e-5
RADAM = RO.AdamConfig(lr=3e-4, clip_norm=1.0)
PADAM = PO.AdamConfig(lr=3e-4, clip_norm=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: a step is hundreds of small ops (DIEN's
    recurrences thousands), which oversubscribed cores slow many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in _np(batch).items()}


# DIEN's last attention bias has a gradient of rounding noise in both
# packages (``dien.SHIFT_INVARIANT_LEAVES``, shared with chip_smoke.py). It
# is held to be noise (at most GRAD_TOL of its layer's weight gradient's
# largest entry) and within GRAD_TOL of that entry.
NOISE_LEAVES = PDI.SHIFT_INVARIANT_LEAVES


def _leaf_err(k, got, want):
    """|port - reference| of leaf ``k`` over its largest reference entry
    (over its weight's, for a leaf of NOISE_LEAVES)."""
    if k not in NOISE_LEAVES:
        return _rel(got[k], want[k])
    scale = float(np.abs(want[NOISE_LEAVES[k]]).max())
    assert float(np.abs(want[k]).max()) <= GRAD_TOL * scale, (k, "not rounding noise")
    g = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) else got[k]
    return float(np.abs(g.astype(np.float64) - want[k]).max()) / scale


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


# arch -> (reference module, configs, batch fn, reference/port step builders)
ARCHS = {
    "dlrm-rm2": (RD, RDL.SMOKE, PDL.SMOKE, RS.dlrm_batch, RST.dlrm_train_step,
                 PST.dlrm_train_step),
    "two-tower-retrieval": (RT, RTC.SMOKE, PTC.SMOKE, RS.tt_batch, RST.tt_train_step,
                            PST.tt_train_step),
    "mind": (RM, RMC.SMOKE, PMC.SMOKE, RS.mind_batch, RST.mind_train_step,
             PST.mind_train_step),
    "dien": (RDI, RDC.SMOKE, PDC.SMOKE, RS.dien_batch, RST.dien_train_step,
             PST.dien_train_step),
}


def _world(arch, batch=16, seed=0):
    mod, rcfg, pcfg, batch_fn, rstep, pstep = ARCHS[arch]
    params = _np(mod.init_params(jax.random.PRNGKey(seed), rcfg))
    b = _np(batch_fn(7, batch, rcfg))
    return params, b, rcfg, pcfg, rstep, pstep


def _port_tree(params):
    return PE.tree_from_numpy(params, device="cpu")


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_matches_the_reference(arch, microbatches):
    params, batch, rcfg, pcfg, rstep, pstep = _world(arch)
    r_new, r_opt, r_m = jax.jit(rstep(rcfg, RADAM, microbatches))(
        params, RO.adam_init(params), batch)
    tree = _port_tree(params)
    p_new, p_opt, p_m = pstep(pcfg, PADAM, microbatches)(tree, PST.init_opt_state(tree),
                                                           _t(batch))
    assert p_new is tree and p_opt.step == 1
    assert float(p_m["loss"]) == pytest.approx(float(r_m["loss"]), rel=LOSS_TOL)
    assert float(p_m["grad_norm"]) == pytest.approx(float(r_m["grad_norm"]), rel=LOSS_TOL)

    ref_flat = {k: np.asarray(v) for k, v in flatten_tree(_np(r_new)).items()}
    init = flatten_tree(params)
    mine = flatten_tree(p_new)
    assert list(ref_flat) == list(mine)
    f32 = np.float32
    bc1, bc2 = f32(1) - f32(RADAM.b1), f32(1) - f32(RADAM.b2)
    for name in ("mu", "nu"):
        want, got = flatten_tree(_np(getattr(r_opt, name))), getattr(p_opt, name)
        assert list(want) == list(got)
        for k in want:
            err = _leaf_err(k, got, want)
            assert err <= GRAD_TOL, (name, k, err)
    for k, p0 in init.items():
        mu, nu = p_opt.mu[k].numpy(), p_opt.nu[k].numpy()
        upd = p0 - f32(RADAM.lr) * ((mu / bc1) / (np.sqrt(nu / bc2) + f32(RADAM.eps)))
        err = float(np.abs(mine[k].numpy().astype(np.float64) - upd).max())
        assert err <= PARAM_TOL * float(np.abs(ref_flat[k]).max()), (k, err)


def _losses(arch, rcfg, pcfg):
    """The reference's and the port's loss functions of ``arch``'s train step."""
    from repro_torch.models.recsys import dien as PDI
    from repro_torch.models.recsys import mind as PM
    from repro_torch.models.recsys import two_tower as PT

    if arch == "dlrm-rm2":
        keys = ("dense", "sparse_ids", "labels")
        return (lambda p, b: RD.bce_loss(p, *(b[k] for k in keys), rcfg),
                lambda p, b: PD.bce_loss(p, *(b[k] for k in keys), pcfg))
    if arch == "two-tower-retrieval":
        keys = ("hist_ids", "hist_mask", "pos_items", "item_logq")
        return (lambda p, b: RT.sampled_softmax_loss(p, *(b[k] for k in keys), rcfg),
                lambda p, b: PT.sampled_softmax_loss(p, *(b[k] for k in keys), pcfg))
    if arch == "mind":
        keys = ("hist_ids", "hist_mask", "pos_items", "neg_items")
        return (lambda p, b: RM.label_aware_loss(p, *(b[k] for k in keys), rcfg),
                lambda p, b: PM.label_aware_loss(p, *(b[k] for k in keys), pcfg))
    keys = ("hist_items", "hist_cates", "hist_mask", "target_item", "target_cate", "labels")
    return (lambda p, b: RDI.bce_loss(p, *(b[k] for k in keys), rcfg),
            lambda p, b: PDI.bce_loss(p, *(b[k] for k in keys), pcfg))


@pytest.mark.parametrize("microbatches", [1, 3])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_gradients_match_the_reference(arch, microbatches):
    """``_accumulate_grads`` in both packages, before clipping."""
    params, batch, rcfg, pcfg, _, _ = _world(arch, batch=12, seed=1)
    rloss, ploss = _losses(arch, rcfg, pcfg)
    r_loss, r_grads = RST._accumulate_grads(rloss, params, batch, microbatches)
    p_loss, p_grads = PST._accumulate_grads(ploss, _port_tree(params), _t(batch), microbatches)
    assert float(p_loss) == pytest.approx(float(r_loss), rel=LOSS_TOL)
    want = flatten_tree(_np(r_grads))
    assert list(want) == list(p_grads)
    for k in want:
        err = _leaf_err(k, p_grads, want)
        assert err <= GRAD_TOL, (k, err)


def test_adam_update_in_place_equals_adam_update():
    """``adam_update_`` (in place, in chunks) gives ``adam_update``'s bits."""
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((37, 5), generator=g), "b": torch.randn((3,), generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in params.items()}
    state = PO.adam_init(params)
    state = state._replace(mu={k: torch.randn(v.shape, generator=g) for k, v in params.items()},
                           nu={k: torch.rand(v.shape, generator=g) for k, v in params.items()},
                           step=4)
    for cfg in (PADAM, PO.AdamConfig(lr=1e-2, clip_norm=0.0, weight_decay=0.1)):
        want_p, want_s = PO.adam_update(grads, state, params, cfg)
        p = {k: v.clone() for k, v in params.items()}
        s = state._replace(mu={k: v.clone() for k, v in state.mu.items()},
                           nu={k: v.clone() for k, v in state.nu.items()})
        new = PO.adam_update_({k: v.clone() for k, v in grads.items()}, s, p, cfg, chunk=16)
        assert new.step == want_s.step == 5
        for k in params:
            assert torch.equal(p[k], want_p[k]) and torch.equal(new.mu[k], want_s.mu[k])
            assert torch.equal(new.nu[k], want_s.nu[k])


# ---------------------------------------------------------------------------
# Serve and retrieval steps.
# ---------------------------------------------------------------------------


def test_serve_steps_match_the_reference():
    rng = np.random.default_rng(3)
    # dlrm-rm2
    params, batch, rcfg, pcfg, _, _ = _world("dlrm-rm2", seed=2)
    got = PST.dlrm_serve_step(pcfg)(_port_tree(params), _t(batch))
    assert _rel(got, RST.dlrm_serve_step(rcfg)(params, batch)) <= SERVE_TOL
    # two-tower
    params, batch, rcfg, pcfg, _, _ = _world("two-tower-retrieval", seed=2)
    batch["cand_ids"] = rng.integers(0, rcfg.item_vocab, 300).astype(np.int32)
    got = PST.tt_serve_step(pcfg)(_port_tree(params), _t(batch))
    assert _rel(got, RST.tt_serve_step(rcfg)(params, batch)) <= SERVE_TOL
    # mind
    params, batch, rcfg, pcfg, _, _ = _world("mind", seed=2)
    got = PST.mind_serve_step(pcfg)(_port_tree(params), _t(batch))
    assert _rel(got, RST.mind_serve_step(rcfg)(params, batch)) <= SERVE_TOL
    # dien
    params, batch, rcfg, pcfg, _, _ = _world("dien", seed=2)
    got = PST.dien_serve_step(pcfg)(_port_tree(params), _t(batch))
    assert _rel(got, RST.dien_serve_step(rcfg)(params, batch)) <= SERVE_TOL


def _candidates(rng, vocab, n):
    """Candidate ids with duplicates (exact ties) beside distinct ids."""
    base = rng.choice(vocab, n // 2, replace=False).astype(np.int32)
    return np.concatenate([base, base[rng.permutation(n // 2)]])


@pytest.mark.parametrize("arch,k", [("two-tower-retrieval", 10), ("two-tower-retrieval", 100),
                                    ("mind", 10), ("mind", 100)])
def test_retrieval_steps_match_the_reference(arch, k):
    rng = np.random.default_rng(4)
    params, batch, rcfg, pcfg, _, _ = _world(arch, batch=6, seed=3)
    batch["cand_ids"] = _candidates(rng, rcfg.item_vocab, 400)
    rbuild, pbuild = ((RST.tt_retrieval_step, PST.tt_retrieval_step)
                      if arch.startswith("two") else
                      (RST.mind_retrieval_step, PST.mind_retrieval_step))
    rv, ri = rbuild(rcfg, k)(params, batch)
    pv, pi = pbuild(pcfg, k)(_port_tree(params), _t(batch))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    assert pi.dtype == torch.int32
    assert _rel(pv, rv) <= SERVE_TOL
    # the duplicated candidates do tie, and the lower position comes first
    cand = batch["cand_ids"]
    ids = pi.numpy()
    for row in ids:
        for a, b in zip(row[:-1], row[1:]):
            if cand[a] == cand[b]:
                assert a < b


def _bebr_world(seed=0, code_dim=16, n_levels=4, N=500):
    cfg = RTC.SMOKE
    key = jax.random.PRNGKey(seed)
    params = dict(RT.init_params(key, cfg))
    emb_out = cfg.tower_mlp[-1]
    ks = jax.random.split(key, 8)
    params["binarizer"] = {
        "W": [jax.random.normal(ks[t], (emb_out, code_dim)) / emb_out**0.5
              for t in range(n_levels)],
        "R": [jax.random.normal(ks[4 + t], (code_dim, emb_out)) / code_dim**0.5
              for t in range(n_levels - 1)],
    }
    cand_codes = jax.random.randint(ks[7], (N, code_dim), 0, 2**n_levels).astype(jnp.int8)
    batch = {
        "hist_ids": (jnp.arange(cfg.hist_len)[None, :] * (seed + 3)) % cfg.user_vocab,
        "hist_mask": jnp.ones((1, cfg.hist_len), jnp.float32),
        "cand_codes": cand_codes,
        "cand_inv": RSR.doc_inv_norms(cand_codes, n_levels),
    }
    return _np(params), _np(batch)


@pytest.mark.parametrize("seed,k", [(0, 20), (1, 100), (2, 1)])
def test_tt_retrieval_bebr_step_matches_the_reference(seed, k):
    params, batch = _bebr_world(seed)
    rv, ri = jax.jit(RST.tt_retrieval_bebr_step(RTC.SMOKE, k=k, code_dim=16, n_levels=4))(
        params, batch)
    pv, pi = PST.tt_retrieval_bebr_step(PTC.SMOKE, k=k, code_dim=16, n_levels=4)(
        _port_tree(params), _t(batch))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    assert _rel(pv, rv) <= 1e-6


# cand_inv <= 0 at chosen docs: (seed, N, k, {doc: inverse norm}). The
# reference scores such a doc affine x inv (0, or the sign flipped) and
# ranks it among the others; the first case is the SMOKE check that found
# the port dropping them (N 40, k 40, docs 3 and 17 at 0).
NONPOSITIVE_CASES = [
    (0, 40, 40, {3: 0.0, 17: 0.0}),
    (1, 40, 10, {3: 0.0, 17: 0.0, 20: -0.0}),
    (2, 60, 25, {0: -0.5, 5: 0.0, 59: -3.0}),
    (3, 50, 60, {1: -1.0, 2: 0.0, 10: -1e-3}),
    (4, 200, 5, {i: 0.0 for i in range(0, 200, 2)}),
    (5, 30, 30, {i: -0.25 for i in range(30)}),
]


def _nonpositive_world(seed, N, overrides):
    params, batch = _bebr_world(seed, N=N)
    inv = batch["cand_inv"].copy()
    for doc, value in overrides.items():
        inv[doc] = value
    batch["cand_inv"] = inv
    return params, batch


@pytest.mark.parametrize("seed,N,k,overrides", NONPOSITIVE_CASES)
def test_tt_retrieval_bebr_step_ranks_nonpositive_inverse_norms(seed, N, k, overrides):
    """A candidate whose inverse norm is 0 or negative competes with the
    reference's score: ids exactly (ties to the lower id, -0.0 below
    +0.0, as ``jax.lax.top_k`` ranks them), scores within 1e-6 relative."""
    params, batch = _nonpositive_world(seed, N, overrides)
    kk = min(k, N)  # jax.lax.top_k takes no k above N
    rv, ri = jax.jit(RST.tt_retrieval_bebr_step(RTC.SMOKE, k=kk, code_dim=16, n_levels=4))(
        params, batch)
    pv, pi = PST.tt_retrieval_bebr_step(PTC.SMOKE, k=k, code_dim=16, n_levels=4)(
        _port_tree(params), _t(batch))
    assert pv.shape == (1, k) and pi.dtype == torch.int32
    np.testing.assert_array_equal(pi[:, :kk].numpy(), np.asarray(ri))
    assert _rel(pv[:, :kk], rv) <= 1e-6
    np.testing.assert_array_equal(np.signbit(pv[:, :kk].numpy()), np.signbit(np.asarray(rv)))
    assert bool((pi[:, kk:] == -1).all())
    if kk == N:  # every candidate ranked, the nonpositive ones included
        assert sorted(pi[0, :N].tolist()) == list(range(N))


def test_merge_topk_breaks_ties_as_the_reference():
    """``_merge_topk`` against ``jax.lax.top_k`` on scores with signed
    zeros and repeated values, the candidates given out of id order."""
    rng = np.random.default_rng(0)
    scores = rng.choice(np.float32([1.5, 0.0, -0.0, -2.0, 7.0]), 64).astype(np.float32)
    ids = rng.permutation(64).astype(np.int32)
    full = np.empty(64, np.float32)
    full[ids] = scores
    rv, ri = jax.lax.top_k(jnp.asarray(full)[None], 20)
    pv, pi = PST._merge_topk(torch.from_numpy(scores), torch.from_numpy(ids), 20)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.numpy().view(np.int32), np.asarray(rv).view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("seed,N,k,overrides", NONPOSITIVE_CASES)
def test_tt_retrieval_bebr_step_nonpositive_on_the_card(seed, N, k, overrides):
    """The same cases on CUDA tensors: the same scores and ids as the CPU
    step, bit for bit, with one ``sdc_topk`` launch for the rows with
    inv > 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.sdc import sdc as PSDC

    params, batch = _nonpositive_world(seed, N, overrides)
    step = PST.tt_retrieval_bebr_step(PTC.SMOKE, k=k, code_dim=16, n_levels=4)
    hv, hi = step(_port_tree(params), _t(batch))
    before = PSDC.sdc_topk.launches
    cv, ci = step(PE.tree_from_numpy(params, device="cuda"),
                  {key: v.cuda() for key, v in _t(batch).items()})
    torch.cuda.synchronize()
    assert PSDC.sdc_topk.launches == before + 1
    assert torch.equal(ci.cpu(), hi)
    assert torch.equal(cv.cpu().view(torch.int32), hv.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("seed,k,N", [(0, 20, 500), (1, 100, 500), (2, 1, 500),
                                      (3, 100, 300_007)])
def test_tt_retrieval_bebr_step_on_the_card_matches_the_reference(seed, k, N, monkeypatch):
    """The step on CUDA tensors: one ``sdc_topk`` launch, the reference's
    ids exactly and its scores within 1e-6 relative, and the kernel's
    output exactly its plain version's (``sdc_topk_torch``) on the same
    card tensors (the query code as the step made it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.sdc import sdc as PSDC

    params, batch = _bebr_world(seed, N=N)
    rv, ri = jax.jit(RST.tt_retrieval_bebr_step(RTC.SMOKE, k=k, code_dim=16, n_levels=4))(
        params, batch)
    seen = []

    def recorded(*args, **kwargs):
        out = PSDC.sdc_topk(*args, **kwargs)
        seen.append((args, kwargs, out))
        return out

    monkeypatch.setattr(PST, "sdc_topk", recorded)
    tree = PE.tree_from_numpy(params, device="cuda")
    before = PSDC.sdc_topk.launches
    pv, pi = PST.tt_retrieval_bebr_step(PTC.SMOKE, k=k, code_dim=16, n_levels=4)(
        tree, {key: v.cuda() for key, v in _t(batch).items()})
    torch.cuda.synchronize()
    assert PSDC.sdc_topk.launches == before + 1 and len(seen) == 1
    assert pv.device.type == "cuda"
    np.testing.assert_array_equal(pi.cpu().numpy(), np.asarray(ri))
    assert _rel(pv.cpu(), rv) <= 1e-6
    args, kwargs, (kv, ki) = seen[0]
    wv, wi = PSDC.sdc_topk_torch(*args, **kwargs)
    assert torch.equal(kv, wv) and torch.equal(ki, wi)


def test_tt_retrieval_bebr_step_refuses_a_batch_of_queries():
    params, batch = _bebr_world(0)
    batch["hist_ids"] = np.repeat(batch["hist_ids"], 2, 0)
    batch["hist_mask"] = np.repeat(batch["hist_mask"], 2, 0)
    with pytest.raises(ValueError, match="one query"):
        PST.tt_retrieval_bebr_step(PTC.SMOKE, k=5, code_dim=16)(_port_tree(params), _t(batch))


def test_train_state_tree_round_trip():
    params, _, _, _, _, _ = _world("mind")
    tree = _port_tree(params)
    opt = PST.init_opt_state(tree)
    opt = opt._replace(step=3)
    full = PST.train_state_tree(tree, opt)
    assert full[1].step.dtype == np.int32 and int(full[1].step) == 3
    back_params, back_opt = PST.train_state_from_tree(full)
    assert back_params is tree and back_opt.step == 3
    assert list(back_opt.mu) == list(flatten_tree(tree))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(ARCHS))
def test_card_step_matches_the_cpu_step(arch):
    """One train step on the card against the same step on the CPU, from
    the reference's weights: the loss and the moments within the same
    tolerances (TF32 is off), the dot_interact kernel launched in dlrm-rm2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.dot_interact import kernel as PK

    params, batch, rcfg, pcfg, _, pstep = _world(arch)
    out = {}
    for dev in ("cpu", "cuda"):
        tree = PE.tree_from_numpy(params, device=dev)
        b = {k: v.to(dev) for k, v in _t(batch).items()}
        before = PK.dot_interact.launches
        _, opt, m = pstep(pcfg, PADAM)(tree, PST.init_opt_state(tree), b)
        out[dev] = (opt, m, PK.dot_interact.launches - before)
    assert out["cuda"][2] == (1 if arch == "dlrm-rm2" else 0)
    assert float(out["cuda"][1]["loss"]) == pytest.approx(float(out["cpu"][1]["loss"]),
                                                          rel=LOSS_TOL)
    for name in ("mu", "nu"):
        want = {k: v.numpy() for k, v in getattr(out["cpu"][0], name).items()}
        got = {k: v.cpu() for k, v in getattr(out["cuda"][0], name).items()}
        for k in want:
            assert _leaf_err(k, got, want) <= GRAD_TOL, (name, k)
