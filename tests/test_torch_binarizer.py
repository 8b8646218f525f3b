"""Eval-mode recurrent binarizer of the PyTorch port against the JAX reference.

The reference's ``init_binarizer`` weights, with batch-norm statistics
randomised by numpy, are converted by ``binarizer_from_numpy``. Pre-sign
activations must agree to float32 rounding (rtol = atol = 1e-5: the two
frameworks sum the matrix products in different orders). Codes may then
differ only where an activation sits at ~0 and its sign flips, which can
cascade through the residual levels of one row; their count is bounded
at 1e-4 of all entries. The checkpoint loader must read the reference's
own archives.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.launch import binarizer_cache as RC  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.launch import binarizer_cache as PC  # noqa: E402


def _configs(dim, code, levels, hidden, input_map=False):
    kw = dict(input_dim=dim, code_dim=code, n_levels=levels, hidden_dim=hidden,
              input_map=input_map)
    return RB.BinarizerConfig(**kw), PB.BinarizerConfig(**kw)


def _reference_weights(cfg, seed=0):
    params, state = RB.init_binarizer(jax.random.PRNGKey(seed), cfg)
    params = jax.tree_util.tree_map(np.array, params)
    state = jax.tree_util.tree_map(np.array, state)
    rng = np.random.default_rng(seed + 1)
    for s in state["W"] + state["R"]:
        if s:
            s["bn_mean"] = (0.1 * rng.normal(size=s["bn_mean"].shape)).astype(np.float32)
            s["bn_var"] = rng.uniform(0.5, 2.0, size=s["bn_var"].shape).astype(np.float32)
    for p in params["W"] + params["R"]:
        if "bn_scale" in p:
            p["bn_scale"] = rng.uniform(0.5, 1.5, size=p["bn_scale"].shape).astype(np.float32)
            p["bn_bias"] = (0.1 * rng.normal(size=p["bn_bias"].shape)).astype(np.float32)
    if "P" in params:
        params["P"] = (params["P"] + 0.05 * rng.normal(size=params["P"].shape)).astype(np.float32)
    return params, state


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("hidden", [0, 128])
@pytest.mark.parametrize("levels", [1, 2, 4])
def test_level0_pre_sign_activations_agree(hidden, levels):
    rcfg, pcfg = _configs(64, 32, levels, hidden)
    params, state = _reference_weights(rcfg)
    f = np.random.default_rng(2).normal(size=(512, 64)).astype(np.float32)
    ref, _ = RB._apply_mlp(_jnp_tree(params["W"][0]), _jnp_tree(state["W"][0]),
                           jnp.asarray(f), train=False, momentum=0.9)
    model = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    with torch.no_grad():
        got = model.W[0](torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("input_map", [False, True])
def test_codes_agree_up_to_sign_flips_near_zero(input_map):
    rcfg, pcfg = _configs(256, 128, 4, 256, input_map)
    params, state = _reference_weights(rcfg, seed=3)
    f = np.random.default_rng(4).normal(size=(4096, 256)).astype(np.float32)
    ref = np.asarray(RB.make_encode_fn(_jnp_tree(params), _jnp_tree(state), rcfg)(f))
    model = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    got = PB.make_encode_fn(model)(f)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    n_diff = int((got.numpy() != ref).sum())
    assert n_diff <= 1e-4 * ref.size, n_diff
    bits_ref, b_u_ref, _ = RB.binarize(_jnp_tree(params), _jnp_tree(state), jnp.asarray(f[:8]),
                                       rcfg)
    bits, b_u = PB.binarize(model, torch.from_numpy(f[:8]))
    assert bits.shape == bits_ref.shape and b_u.shape == b_u_ref.shape
    np.testing.assert_array_equal(PB.pack_codes(bits).numpy(), ref[:8])
    np.testing.assert_array_equal(PB.binarize_eval(model, torch.from_numpy(f[:8])).numpy(),
                                  b_u.numpy())


def test_load_checkpoint_reads_the_reference_archive(tmp_path):
    rcfg, pcfg = _configs(64, 32, 4, 128)
    params, state = _reference_weights(rcfg, seed=5)
    path = str(tmp_path / "ckpt.npz")
    RC._save(path, _jnp_tree(params), _jnp_tree(state))
    with np.load(path) as z:
        assert len(z.files) == 56
    loaded = PC.load_checkpoint(path, pcfg, device="cpu")
    direct = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    a, b = loaded.state_dict(), direct.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    np.testing.assert_array_equal(loaded.W[1].inp.weight.detach().numpy(), params["W"][1]["in"]["w"].T)
    np.testing.assert_array_equal(loaded.R[2].bn_var.numpy(), state["R"][2]["bn_var"])


@pytest.mark.parametrize("hidden,input_map", [(0, False), (16, True)])
def test_load_checkpoint_other_layouts(tmp_path, hidden, input_map):
    rcfg, pcfg = _configs(16, 8, 2, hidden, input_map)
    params, state = _reference_weights(rcfg, seed=6)
    path = str(tmp_path / "ckpt.npz")
    RC._save(path, _jnp_tree(params), _jnp_tree(state))
    loaded = PC.load_checkpoint(path, pcfg, device="cpu")
    direct = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    for (ka, va), (kb, vb) in zip(loaded.state_dict().items(), direct.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_load_checkpoint_rejects_a_mismatched_config(tmp_path):
    rcfg, _ = _configs(64, 32, 4, 128)
    params, state = _reference_weights(rcfg)
    path = str(tmp_path / "ckpt.npz")
    RC._save(path, _jnp_tree(params), _jnp_tree(state))
    with pytest.raises(ValueError):
        PC.load_checkpoint(path, PB.BinarizerConfig(64, 32, 3, 128), device="cpu")
    with pytest.raises(ValueError):
        PC.load_checkpoint(path, PB.BinarizerConfig(64, 16, 4, 128), device="cpu")


def test_init_binarizer_is_seeded_and_scaled():
    cfg = PB.BinarizerConfig(input_dim=256, code_dim=128, n_levels=4, hidden_dim=512)
    a = PB.init_binarizer(cfg, prng.key(0, "cpu"), device="cpu")
    b = PB.init_binarizer(cfg, prng.key(0, "cpu"), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert len(a.W) == 4 and len(a.R) == 3
    w = a.W[0].inp.weight
    assert w.shape == (512, 256)
    assert abs(float(w.detach().std()) - float(np.sqrt(2.0 / 256))) < 0.01
    assert float(a.W[0].inp.bias.abs().max()) == 0.0
    assert torch.equal(a.W[0].bn_var, torch.ones(512))
    assert not a.training


# ---------------------------------------------------------------------------
# The training half: the STE, train-mode batch norm, gradients, conversion.
# ---------------------------------------------------------------------------


def test_ste_sign_forward_and_gradient_window_equal_the_reference():
    """sign maps 0 to -1; the gradient passes where |x| <= 1, inclusive."""
    x = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 1e-8, 0.5, 1.0, 1.0000001, 2.0], np.float32)
    g = np.arange(1, x.size + 1, dtype=np.float32)
    ref_out, vjp = jax.vjp(RB.ste_sign, jnp.asarray(x))
    (ref_grad,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_(True)
    out = PB.ste_sign(t)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref_grad))
    np.testing.assert_array_equal(out.detach().numpy(), [-1, -1, -1, -1, -1, 1, 1, 1, 1, 1])
    np.testing.assert_array_equal(t.grad.numpy(), [0, 2, 3, 4, 5, 6, 7, 8, 0, 0])


def test_train_mode_batch_norm_equals_the_reference():
    """Integer inputs through an identity layer make the batch's mean and
    biased variance exact in both, so the running statistics
    ``m * old + (1 - m) * batch`` must agree bit for bit; the outputs (one
    rsqrt and two products) within float32 rounding."""
    rcfg, pcfg = _configs(8, 4, 1, 8)
    params, state = _reference_weights(rcfg, seed=7)
    mlp_p = params["W"][0]
    mlp_p["in"]["w"] = np.eye(8, dtype=np.float32)
    mlp_p["in"]["b"] = np.zeros(8, np.float32)
    h = np.random.default_rng(8).integers(-4, 5, (16, 8)).astype(np.float32)
    for momentum in (0.9, 0.5):
        ref_y, ref_s = RB._apply_mlp(_jnp_tree(mlp_p), _jnp_tree(state["W"][0]), jnp.asarray(h),
                                     train=True, momentum=momentum)
        mlp = PB.binarizer_from_numpy(params, state, pcfg, device="cpu").W[0]
        mlp.momentum = momentum
        y = mlp(torch.from_numpy(h), train=True)
        np.testing.assert_array_equal(mlp.bn_mean.numpy(), np.asarray(ref_s["bn_mean"]))
        np.testing.assert_array_equal(mlp.bn_var.numpy(), np.asarray(ref_s["bn_var"]))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("input_map", [False, True])
def test_train_mode_binarize_gradients_and_stats_agree(input_map):
    """One train-mode forward and backward of a loss on b_u: the gradient of
    every parameter and the new running statistics within float32
    rounding of the reference's (rtol 1e-5 of each leaf's largest entry; a
    batch-normed bias ``in.b`` has a gradient that is rounding noise, held
    against the global scale)."""
    rcfg, pcfg = _configs(32, 16, 3, 24, input_map)
    params, state = _reference_weights(rcfg, seed=9)
    f = np.random.default_rng(10).normal(size=(64, 32)).astype(np.float32)
    w = np.random.default_rng(11).normal(size=(64, 16)).astype(np.float32)

    def loss(p):
        _, b_u, new_state = RB.binarize(p, _jnp_tree(state), jnp.asarray(f), rcfg, train=True)
        return jnp.sum(b_u * jnp.asarray(w)) + jnp.sum(b_u ** 2), new_state

    (_, ref_state), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        _jnp_tree(params))
    model = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    bits, b_u = PB.binarize(model, torch.from_numpy(f), train=True)
    assert b_u.requires_grad and bits.shape == (64, 3, 16)
    (torch.sum(b_u * torch.from_numpy(w)) + torch.sum(b_u ** 2)).backward()
    ref_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ref_grads))
    got = PB.param_leaves(model)
    assert len(ref_leaves) == len(got)
    scale = max(float(np.abs(g).max()) for g in ref_leaves)
    for (key, p), g in zip(got.items(), ref_leaves):
        pg = p.grad.numpy().T if key.endswith("/w") else p.grad.numpy()
        assert pg.shape == g.shape, key
        tol = 1e-5 * (scale if key.endswith("in/b") else float(np.abs(g).max()))
        assert float(np.abs(pg - g).max()) <= tol, key
    ref_stats = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ref_state))
    for (key, s), r in zip(PB.state_leaves(model).items(), ref_stats):
        np.testing.assert_allclose(s.numpy(), r, rtol=1e-5, atol=1e-6, err_msg=key)


def test_eval_mode_leaves_stats_and_binarizer_to_numpy_round_trips():
    rcfg, pcfg = _configs(32, 16, 3, 24, True)
    params, state = _reference_weights(rcfg, seed=12)
    model = PB.binarizer_from_numpy(params, state, pcfg, device="cpu")
    before = {k: v.clone() for k, v in PB.state_leaves(model).items()}
    PB.binarize(model, torch.randn(8, 32))
    for k, v in PB.state_leaves(model).items():
        assert torch.equal(v, before[k]), k
    p2, s2 = PB.binarizer_to_numpy(model)
    ref = jax.tree_util.tree_leaves_with_path((params, state))
    got = jax.tree_util.tree_leaves_with_path((p2, s2))
    assert [jax.tree_util.keystr(k) for k, _ in ref] == [jax.tree_util.keystr(k) for k, _ in got]
    for (_, a), (_, b) in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert list(PB.param_leaves(model))[:3] == ["P", "R/0/bn_bias", "R/0/bn_scale"]
    assert [x.shape for x in PB.numpy_leaves(model)] == [s for *_, s in PB.leaf_layout(pcfg)]
