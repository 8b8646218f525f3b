"""Contrastive losses, the momentum queue and hard-negative mining of the
PyTorch port against the JAX reference (``repro/core/losses.py``).

The same numpy inputs go through both. Mining and the queue must agree
exactly: the mined rows are copies of queue rows, chosen in
``jax.lax.top_k``'s order (ties to the lower row), and the tests' queue
rows and anchors are grid vectors, so cosines tie exactly wherever rows
repeat. The losses and cosines agree to float32 rounding (rtol 1e-6,
atol 1e-7: the two frameworks sum the products in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.losses as RL  # noqa: E402
from repro_torch.core import losses as PL  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _queues(length, dim, batches):
    rq = RL.init_queue(RL.QueueConfig(length=length, dim=dim, top_k=1))
    pq = PL.init_queue(PL.QueueConfig(length=length, dim=dim, top_k=1), device="cpu")
    for b in batches:
        rq = RL.queue_push(rq, jnp.asarray(b))
        pq = PL.queue_push(pq, _t(b))
    return rq, pq


def _same_queue(rq, pq):
    np.testing.assert_array_equal(pq["buf"].numpy(), np.asarray(rq["buf"]))
    assert pq["ptr"] == int(rq["ptr"]) and pq["filled"] == int(rq["filled"])


def _grid(rng, shape):
    """Recurrent binary grid values (n_levels 3): sums of +-1, +-1/2, +-1/4."""
    levels = rng.choice([-1.0, 1.0], size=(3,) + shape)
    return (levels[0] + 0.5 * levels[1] + 0.25 * levels[2]).astype(np.float32)


@pytest.mark.parametrize("sizes", [(3, 3, 3), (5, 7, 2), (16,), (12, 9)])
def test_queue_push_fifo_wraps_like_the_reference(sizes):
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(n, 4)).astype(np.float32) for n in sizes]
    rq, pq = _queues(16, 4, batches)
    _same_queue(rq, pq)
    assert pq["buf"].device.type == "cpu"


def test_init_queue_defaults_to_the_card():
    cfg = PL.QueueConfig(length=8, dim=4, top_k=2)
    if torch.cuda.is_available():
        assert PL.init_queue(cfg)["buf"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.init_queue(cfg)


def test_cosine_and_info_nce_agree():
    rng = np.random.default_rng(1)
    a, p = rng.normal(size=(2, 6, 8)).astype(np.float32)
    neg = rng.normal(size=(6, 5, 8)).astype(np.float32)
    np.testing.assert_allclose(PL.cosine(_t(a), _t(p)).numpy(),
                               np.asarray(RL.cosine(jnp.asarray(a), jnp.asarray(p))),
                               rtol=RTOL, atol=ATOL)
    for temp in (0.07, 0.2):
        ref = float(RL.info_nce(jnp.asarray(a), jnp.asarray(p), jnp.asarray(neg),
                                temperature=temp))
        got = float(PL.info_nce(_t(a), _t(p), _t(neg), temperature=temp))
        assert got == pytest.approx(ref, rel=RTOL, abs=ATOL)
        got_bc = float(PL.backward_compat_nce(_t(a), _t(p), _t(neg), temperature=temp))
        assert got_bc == got


def test_info_nce_gradient_agrees():
    import jax

    rng = np.random.default_rng(2)
    a, p = rng.normal(size=(2, 6, 8)).astype(np.float32)
    neg = rng.normal(size=(6, 5, 8)).astype(np.float32)
    ref = jax.grad(lambda x: RL.info_nce(x, jnp.asarray(p), jnp.asarray(neg)))(jnp.asarray(a))
    x = _t(a).requires_grad_(True)
    PL.info_nce(x, _t(p), _t(neg)).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("filled", [0, 3, 10, 40])
@pytest.mark.parametrize("exclusion", [None, 0.999, 0.5])
def test_mining_equals_the_reference(filled, exclusion):
    """Unfilled rows read -inf; on a cold queue every row ties, so rows
    0..top_k-1 (zero vectors) are mined; repeated grid rows tie exactly and
    go to the lower row; the positive exclusion is a strict ``>``."""
    rng = np.random.default_rng(filled)
    length, dim, top_k = 32, 8, 6
    base = _grid(rng, (12, dim))
    rows = base[rng.integers(0, 12, filled)]  # repeats: exact ties
    batches = [rows[i:i + 7] for i in range(0, filled, 7)]
    rq, pq = _queues(length, dim, batches)
    anchors = base[rng.integers(0, 12, 5)]
    positives = base[rng.integers(0, 12, 5)]
    if exclusion is None:
        ref = RL.mine_hard_negatives(rq, jnp.asarray(anchors), top_k)
        got = PL.mine_hard_negatives(pq, _t(anchors), top_k)
    else:
        ref = RL.mine_hard_negatives(rq, jnp.asarray(anchors), top_k,
                                     positives=jnp.asarray(positives), pos_exclusion_sim=exclusion)
        got = PL.mine_hard_negatives(pq, _t(anchors), top_k, positives=_t(positives),
                                     pos_exclusion_sim=exclusion)
    assert got.shape == (5, top_k, dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if filled == 0:
        np.testing.assert_array_equal(got.numpy(), 0.0)


def test_positive_exclusion_is_strict():
    """Row 0 has cosine exactly 0.5 to the positive: kept at 0.5, dropped
    just below it."""
    rows = np.array([[1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 1.0]], np.float32)
    rq, pq = _queues(4, 4, [rows])
    anchor = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
    for sim, want in ((0.5, rows[0]), (0.4999, rows[1])):
        ref = RL.mine_hard_negatives(rq, jnp.asarray(anchor), 1, positives=jnp.asarray(anchor),
                                     pos_exclusion_sim=sim)
        got = PL.mine_hard_negatives(pq, _t(anchor), 1, positives=_t(anchor),
                                     pos_exclusion_sim=sim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy()[0, 0], want)


def test_ema_update_agrees():
    rng = np.random.default_rng(3)
    online = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    mom = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in online.items()}
    for decay in (0.999, 0.9):
        ref = RL.ema_update({k: jnp.asarray(v) for k, v in online.items()},
                            {k: jnp.asarray(v) for k, v in mom.items()}, decay)
        got = PL.ema_update({k: _t(v) for k, v in online.items()},
                            {k: _t(v) for k, v in mom.items()}, decay)
        assert list(got) == ["a", "b"]
        for k in online:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL)
