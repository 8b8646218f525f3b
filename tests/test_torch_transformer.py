"""The LM transformer family in the PyTorch port
(``repro_torch/models/transformer.py``, its five arch configs and the LM
steps) against the JAX reference, on the reference's weights (as numpy,
through ``transformer_from_numpy``) and batches, on the CPU.

Tolerances (float32 unless stated):
  * ``rms_norm``, ``rope``: 1e-6 absolute (inputs ~N(0, 1)); bfloat16
    ``rms_norm``: within one bfloat16 rounding (2^-7 relative);
  * chunked == full attention: 1e-5 (the reference's own test);
  * ``forward`` logits 1e-5 absolute, the aux and ``lm_loss`` 1e-5
    relative; ``prefill`` and float-cache ``decode_step`` logits 1e-5;
  * int8-cache decode: the port's logits within 5e-3 of each row's
    largest |logit| of the reference's int8-cache logits (a float32
    difference can round one cache entry to the next int8 step), and
    within 0.05 of the float cache's (the reference's own bound);
  * MoE routing: ``gate_idx`` exactly, ties to the lower expert;
  * one ``lm_train_step``: the loss and gradient norm 1e-5 relative,
    Adam's moments within 1e-4 of each leaf's largest entry, the
    parameters within 1e-5 of each leaf's largest entry, with
    microbatches 1 and 4;
  * shapes: ``init_params`` on the meta device equal the reference's
    ``jax.eval_shape(init_params)`` leaf for leaf, and their element
    count equals ``param_count`` for all five full configs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import grok_1_314b as RG  # noqa: E402
from repro.configs.archs import llama3_2_1b as R1B  # noqa: E402
from repro.configs.archs import llama3_405b as R405  # noqa: E402
from repro.configs.archs import llama4_scout as RL4  # noqa: E402
from repro.configs.archs import mistral_large_123b as RMI  # noqa: E402
from repro.models import transformer as R  # noqa: E402
from repro.train import optim as RO  # noqa: E402
from repro.train import steps as RST  # noqa: E402
from repro_torch.configs.archs import grok_1_314b as PG  # noqa: E402
from repro_torch.configs.archs import llama3_2_1b as P1B  # noqa: E402
from repro_torch.configs.archs import llama3_405b as P405  # noqa: E402
from repro_torch.configs.archs import llama4_scout as PL4  # noqa: E402
from repro_torch.configs.archs import mistral_large_123b as PMI  # noqa: E402
from repro_torch.models import transformer as P  # noqa: E402
from repro_torch.train import optim as PO  # noqa: E402
from repro_torch.train import steps as PST  # noqa: E402
from repro_torch.train.checkpoint import flatten_tree  # noqa: E402

TOL = 1e-5
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.int8: torch.int8}
# arch id -> (reference config module, port config module)
CONFIGS = {
    "llama3-405b": (R405, P405),
    "llama3.2-1b": (R1B, P1B),
    "mistral-large-123b": (RMI, PMI),
    "llama4-scout-17b-a16e": (RL4, PL4),
    "grok-1-314b": (RG, PG),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: a step is hundreds of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(**kw):
    """A small config as (reference, port): the reference test's widths."""
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                head_dim=8, remat=False, attn_chunk=0)
    base.update(kw)
    return (R.TransformerConfig(dtype=jnp.float32, **base),
            P.TransformerConfig(dtype=torch.float32, **base))


def _port_cfg(rcfg, **kw):
    """The port's config with the same fields as the reference's ``rcfg``."""
    fields = {f: getattr(rcfg, f) for f in R.TransformerConfig.__dataclass_fields__}
    fields["dtype"] = DTYPES[fields["dtype"]]
    fields["kv_cache_dtype"] = DTYPES[fields["kv_cache_dtype"]]
    fields.update(kw)
    return P.TransformerConfig(**fields)


def _world(rcfg, batch=2, seq=12, seed=0):
    params = _np(R.init_params(jax.random.PRNGKey(seed), rcfg))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(seed + 1), (batch, seq), 0,
                                         rcfg.vocab))
    return params, toks


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(want, np.float64)).max())


def _rel(got, want):
    return _err(got, want) / max(float(np.abs(np.asarray(want, np.float64)).max()), 1e-30)


# ---------------------------------------------------------------------------
# Primitives.
# ---------------------------------------------------------------------------


def test_rms_norm_matches_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    want = R.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    assert _err(P.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)), want) <= 1e-6
    # bfloat16: the mean of squares in float32, the rsqrt cast to bfloat16
    xb, sb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16)
    got = P.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                     torch.from_numpy(scale).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(R.rms_norm(xb, sb).astype(jnp.float32))
    assert np.all(np.abs(got.float().numpy() - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


@pytest.mark.parametrize("theta,hd", [(500000.0, 16), (10000.0, 64)])
def test_rope_matches_the_reference(theta, hd):
    """Split halves (not interleaved pairs), positions [1, S] and [B, S]."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    for pos in (np.arange(7, dtype=np.int32)[None, :],
                rng.integers(0, 40000, (2, 7)).astype(np.int32)):
        want = R.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = P.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        assert _err(got, want) <= 1e-6 * max(1.0, float(np.abs(pos).max()) ** 0.5 / 10)


def test_chunked_attention_equals_full_and_the_reference():
    rf, pf = _cfgs()
    rc, pc = _cfgs(attn_chunk=4)
    params, _ = _world(rf)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 64))
    tree = P.transformer_from_numpy(params, "cpu")
    full, _ = P.forward(tree, torch.from_numpy(toks), pf)
    chunked, _ = P.forward(tree, torch.from_numpy(toks), pc)
    assert _err(chunked, full.numpy()) <= TOL
    want, _ = R.forward(params, toks, rc)
    assert _err(chunked, want) <= TOL


def test_weights_carry_across_bit_for_bit():
    """bfloat16 and float32 leaves of the reference's tree, the same bits."""
    rcfg = dataclasses.replace(R1B.SMOKE, dtype=jnp.bfloat16)
    params = _np(R.init_params(jax.random.PRNGKey(0), rcfg))
    tree = P.transformer_from_numpy(params, "cpu")
    flat = flatten_tree(tree)
    want = flatten_tree(params)
    assert list(flat) == list(want)
    for k, a in want.items():
        assert flat[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(flat[k].view(torch.int16).numpy(), a.view(np.int16))


# ---------------------------------------------------------------------------
# Forward, loss, MoE routing.
# ---------------------------------------------------------------------------


LM_SMOKES = list(CONFIGS)


@pytest.mark.parametrize("arch", LM_SMOKES)
def test_forward_and_loss_match_the_reference(arch):
    rmod, pmod = CONFIGS[arch]
    params, toks = _world(rmod.SMOKE, batch=3, seq=16)
    tree = P.transformer_from_numpy(params, "cpu")
    rl, ra = R.forward(params, toks, rmod.SMOKE)
    pl, pa = P.forward(tree, torch.from_numpy(toks), pmod.SMOKE)
    assert pl.shape == (3, 16, rmod.SMOKE.vocab) and pl.dtype == torch.float32
    assert _err(pl, rl) <= TOL
    assert abs(float(pa) - float(ra)) <= TOL * max(1.0, abs(float(ra)))
    labels = np.roll(toks, -1, 1)
    want = float(R.lm_loss(params, toks, labels, rmod.SMOKE))
    got = float(P.lm_loss(tree, torch.from_numpy(toks), torch.from_numpy(labels), pmod.SMOKE))
    assert abs(got - want) <= TOL * abs(want)


def test_bfloat16_forward_close_to_the_reference():
    """A bfloat16 config on the reference's bfloat16 weights: the logits
    within 2% of the largest (bfloat16 products summed in other orders)."""
    rcfg = dataclasses.replace(R1B.SMOKE, dtype=jnp.bfloat16)
    params, toks = _world(rcfg, batch=2, seq=8)
    rl, _ = R.forward(params, toks, rcfg)
    pl, _ = P.forward(P.transformer_from_numpy(params, "cpu"), torch.from_numpy(toks),
                      _port_cfg(rcfg))
    assert pl.dtype == torch.bfloat16
    assert _rel(pl.float(), np.asarray(rl.astype(jnp.float32))) <= 0.02


def test_moe_routing_matches_the_reference_with_ties():
    """``gate_idx`` exactly as ``jax.lax.top_k`` gives it, on router
    probabilities with exact ties (repeated router columns): ties go to
    the lower expert."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    router = rng.normal(size=(16, 6)).astype(np.float32)
    router[:, 3] = router[:, 1]  # experts 1 and 3 tie for every token
    router[:, 5] = router[:, 0]
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1)
    for k in (1, 2, 3):
        rv, ri = jax.lax.top_k(probs, k)
        pv, pi = P._route_topk(torch.from_numpy(np.asarray(probs)), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    p = np.asarray(probs)
    assert np.array_equal(p[..., 1], p[..., 3]) and np.array_equal(p[..., 0], p[..., 5])


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_capacity_drops_overflow_as_the_reference(top_k):
    """capacity_factor 0.5: C = 4 slots an expert, so tokens are dropped
    (counted here from the reference's formula); the port's logits and
    aux still equal the reference's, which they would not if it dropped
    other tokens."""
    rc, pc = _cfgs(n_experts=2, top_k=top_k, capacity_factor=0.5)
    params, _ = _world(rc)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 64))
    rl, ra = R.forward(params, toks, rc)
    pl, pa = P.forward(P.transformer_from_numpy(params, "cpu"), torch.from_numpy(toks), pc)
    assert not bool(torch.isnan(pl).any()) and float(pa) > 0
    assert _err(pl, rl) <= TOL and abs(float(pa) - float(ra)) <= TOL
    cap = max(int(0.5 * 16 * top_k / 2), 4)
    assert 16 * top_k > 2 * cap  # more (token, slot) pairs than the experts hold


def test_moe_routing_groups():
    """``moe_group``: a sequence longer than the group is routed in groups
    of that many tokens, each with its own capacity, as the reference."""
    rc, pc = _cfgs(n_experts=4, top_k=2, capacity_factor=0.5, moe_group=8)
    params, _ = _world(rc)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 32), 0, 64))
    rl, ra = R.forward(params, toks, rc)
    pl, pa = P.forward(P.transformer_from_numpy(params, "cpu"), torch.from_numpy(toks), pc)
    assert _err(pl, rl) <= TOL and abs(float(pa) - float(ra)) <= TOL
    ungrouped, _ = P.forward(P.transformer_from_numpy(params, "cpu"), torch.from_numpy(toks),
                             dataclasses.replace(pc, moe_group=0))
    assert _err(pl, ungrouped.numpy()) > TOL  # the groups change which tokens drop


# ---------------------------------------------------------------------------
# Prefill and decode.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moe", [False, True])
def test_prefill_matches_the_reference(moe):
    rc, pc = _cfgs(**(dict(n_experts=4, top_k=2) if moe else {}))
    params, toks = _world(rc, batch=3, seq=12)
    want = R.prefill(params, toks, rc)
    got = P.prefill(P.transformer_from_numpy(params, "cpu"), torch.from_numpy(toks), pc)
    assert got.shape == (3, 64) and _err(got, want) <= TOL


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_decode_matches_the_reference(moe, cache):
    kw = dict(n_experts=4, top_k=2, capacity_factor=8.0) if moe else {}
    rc, pc = _cfgs(**kw)
    params, toks = _world(rc, batch=2, seq=8)
    tree = P.transformer_from_numpy(params, "cpu")
    rdt, pdt = (jnp.float32, torch.float32) if cache == "float32" else (jnp.int8, torch.int8)
    rcache = R.init_kv_cache(rc, 2, 16, dtype=rdt)
    pcache = P.init_kv_cache(pc, 2, 16, dtype=pdt, device="cpu")
    assert set(pcache) == set(rcache)
    for k in rcache:
        if k != "length":
            assert tuple(pcache[k].shape) == rcache[k].shape and pcache[k].dtype == DTYPES[
                rcache[k].dtype.type], k
    step = PST.lm_decode_step(pc)
    for t in range(8):
        rl, rcache = R.decode_step(params, toks[:, t], rcache, rc)
        pl, pcache = step(tree, {"token": torch.from_numpy(toks[:, t])}, pcache)
        assert pcache["length"] == int(rcache["length"]) == t + 1
        if cache == "float32":
            assert _err(pl, rl) <= TOL
        else:
            row_max = np.abs(np.asarray(rl)).max(-1, keepdims=True)
            assert bool((np.abs(pl.numpy() - np.asarray(rl)) <= 5e-3 * row_max).all())
    if cache == "float32":
        np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(rcache["k"]), atol=TOL)
    else:  # one rounding step at most, on a few entries
        diff = np.abs(pcache["k"].numpy().astype(np.int32) - np.asarray(rcache["k"], np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("moe", [False, True])
def test_decode_matches_forward(moe):
    """Token-by-token decode equals the full forward (the reference's own
    test and bound: 1e-5 dense, 2e-2 MoE, routed per token at decode)."""
    kw = dict(n_experts=4, top_k=2, capacity_factor=8.0) if moe else {}
    _, pc = _cfgs(**kw)
    rc, _ = _cfgs(**kw)
    params, toks = _world(rc, batch=2, seq=8)
    tree = P.transformer_from_numpy(params, "cpu")
    cache = P.init_kv_cache(pc, 2, 16, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = P.decode_step(tree, torch.from_numpy(toks[:, t]), cache, pc)
        outs.append(lg)
    full, _ = P.forward(tree, torch.from_numpy(toks), pc)
    assert _err(torch.stack(outs, 1), full.numpy()) <= (2e-2 if moe else TOL)


def test_int8_cache_close_to_float_cache():
    rc, pc = _cfgs()
    params, toks = _world(rc, batch=2, seq=10)
    tree = P.transformer_from_numpy(params, "cpu")
    c_fp = P.init_kv_cache(pc, 2, 16, dtype=torch.float32, device="cpu")
    c_q = P.init_kv_cache(pc, 2, 16, dtype=torch.int8, device="cpu")
    assert "k_scale" in c_q and "k_scale" not in c_fp
    for t in range(10):
        lf, c_fp = P.decode_step(tree, torch.from_numpy(toks[:, t]), c_fp, pc)
        lq, c_q = P.decode_step(tree, torch.from_numpy(toks[:, t]), c_q, pc)
    rel = float((lf - lq).abs().max() / (lf.abs().max() + 1e-9))
    assert 0 < rel < 0.05


def test_quantize_kv_matches_the_reference():
    """Per-token int8 with half-to-even rounding: the codes and scales exactly."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves of the scale below
    x[0, 0, 0, 4:] = 0.0
    x[0, 0, 0, 4] = 127.0  # scale = 1 + 1e-8 rounds to 1.0 in float32
    rq, rs = R._quantize_kv(jnp.asarray(x))
    pq, ps = P._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pq.numpy()[0, 0, 0, :4], [0, 0, 2, 2])


# ---------------------------------------------------------------------------
# The train step.
# ---------------------------------------------------------------------------


def _leaf_rel(got, want):
    return _err(got, want) / max(float(np.abs(np.asarray(want)).max()), 1e-30)


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("moe", [False, True])
def test_lm_train_step_matches_the_reference(moe, microbatches):
    kw = dict(n_experts=4, top_k=2) if moe else {}
    rc, pc = _cfgs(microbatches=microbatches, **kw)
    params, toks = _world(rc, batch=8, seq=16)
    labels = np.roll(toks, -1, 1)
    radam = RO.AdamConfig(lr=3e-4, clip_norm=1.0)
    padam = PO.AdamConfig(lr=3e-4, clip_norm=1.0)
    rp, ropt, rm = jax.jit(RST.lm_train_step(rc, radam))(
        params, RO.adam_init(params), {"tokens": toks, "labels": labels})
    tree = P.transformer_from_numpy(params, "cpu")
    pp, popt, pm = PST.lm_train_step(pc, padam)(
        tree, PST.init_opt_state(tree),
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= TOL * abs(float(rm["loss"]))
    assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= TOL * float(rm["grad_norm"])
    assert popt.step == 1 and int(ropt.step) == 1
    for name in ("mu", "nu"):
        want = flatten_tree(_np(getattr(ropt, name)))
        got = getattr(popt, name)
        assert list(got) == list(want)
        for k in want:
            assert _leaf_rel(got[k], want[k]) <= 1e-4, (name, k)
    want = flatten_tree(_np(rp))
    for k, t in flatten_tree(pp).items():
        assert _leaf_rel(t, want[k]) <= TOL, k


def test_microbatch_accumulation_matches_full_batch():
    """The reference's own invariant, on the port: microbatches 1 and 4
    give the same loss (1e-4 relative) and parameters (2e-4)."""
    _, p1 = _cfgs(microbatches=1)
    rc, p4 = _cfgs(microbatches=4)
    params, toks = _world(rc, batch=8, seq=16)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    adam = PO.AdamConfig(lr=1e-2, clip_norm=0.0)
    out = []
    for cfg in (p1, p4):
        tree = P.transformer_from_numpy(params, "cpu")
        out.append(PST.lm_train_step(cfg, adam)(tree, PST.init_opt_state(tree), batch))
    (a, _, m1), (b, _, m4) = out
    assert abs(float(m1["loss"]) - float(m4["loss"])) <= 1e-4 * abs(float(m1["loss"]))
    for k, t in flatten_tree(a).items():
        assert _err(t, flatten_tree(b)[k].numpy()) <= 2e-4, k


def test_remat_changes_no_gradient():
    """``remat`` (torch.utils.checkpoint per layer) gives the same loss and
    gradients as the plain backward, bit for bit."""
    rc, pc = _cfgs(n_experts=4, top_k=2)
    params, toks = _world(rc, batch=2, seq=16)
    grads = []
    for remat in (False, True):
        tree = P.transformer_from_numpy(params, "cpu")
        loss, g = PST._value_and_grad(
            lambda p, b: P.lm_loss(p, b["tokens"], b["labels"],
                                   dataclasses.replace(pc, remat=remat)),
            tree, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)})
        grads.append((loss, g))
    assert torch.equal(grads[0][0], grads[1][0])
    for k in grads[0][1]:
        assert torch.equal(grads[0][1][k], grads[1][1][k]), k


# ---------------------------------------------------------------------------
# Configs and shapes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_full_config_shapes_and_param_count(arch):
    """The full config field for field, ``init_params`` on the meta device
    leaf for leaf against ``jax.eval_shape`` of the reference's, and the
    element count equal to ``param_count`` (which equals the reference's)."""
    rmod, pmod = CONFIGS[arch]
    for rcfg, pcfg in ((rmod.CONFIG, pmod.CONFIG), (rmod.SMOKE, pmod.SMOKE)):
        assert pcfg == _port_cfg(rcfg)
        assert pcfg.param_count() == rcfg.param_count()
        assert pcfg.active_param_count() == rcfg.active_param_count()
    shapes = flatten_tree(jax.eval_shape(lambda: R.init_params(jax.random.PRNGKey(0),
                                                               rmod.CONFIG)))
    meta = flatten_tree(P.init_params(pmod.CONFIG, device="meta"))
    assert list(meta) == list(shapes)
    for k, s in shapes.items():
        assert tuple(meta[k].shape) == s.shape and meta[k].dtype == DTYPES[s.dtype.type], k
    assert sum(t.numel() for t in meta.values()) == pmod.CONFIG.param_count()


def test_llama3_2_1b_is_a_billion_parameters():
    assert 1.2e9 < P1B.CONFIG.param_count() < 1.3e9
