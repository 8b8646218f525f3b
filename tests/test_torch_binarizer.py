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
    a = PB.init_binarizer(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = PB.init_binarizer(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert len(a.W) == 4 and len(a.R) == 3
    w = a.W[0].inp.weight
    assert w.shape == (512, 256)
    assert abs(float(w.detach().std()) - float(np.sqrt(2.0 / 256))) < 0.01
    assert float(a.W[0].inp.bias.abs().max()) == 0.0
    assert torch.equal(a.W[0].bn_var, torch.ones(512))
    assert not a.training
