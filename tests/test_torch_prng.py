"""``repro_torch.prng`` against ``jax.random`` (threefry-2x32, partitionable)
on the CPU.

Keys, ``split``, ``fold_in``, ``bits``, ``uniform``, ``randint`` (spans 1,
7, 2^31 - 1 and 100,000, a negative minval, the full int32 range),
``bernoulli`` and ``choice`` (with and without replacement, and with
``p``) equal the reference's bit for bit over seeds 0-19 and shapes (),
[1], [3, 5, 7] and one of 2^20 elements.

``normal`` emulates XLA's CPU erf_inv (its log1p and its fused
multiply-adds), each fused one as a float64 product and sum rounded to
float32: a double rounding can differ from the single one about once in
2^28 operations, so the bound is one ulp. Measured: every one of the
2^20 draws of each of seeds 0-19 bit-equal (the count is printed).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402

SEEDS = range(20)
SHAPES = [(), (1,), (3, 5, 7)]
BIG = (1 << 20,)
NORMAL_ULPS = 1  # measured: 0 on every draw of seeds 0-19
SPANS = [(0, 1), (0, 7), (0, 2**31 - 1), (0, 100_000), (-5, 5), (3, 3), (-2**31, 2**31 - 1)]


def _k(seed):
    return jax.random.PRNGKey(seed), prng.key(seed, "cpu")


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", list(SEEDS) + [20230713, 2**31 - 1, -1])
def test_keys_split_and_fold_in(seed):
    rk, pk = _k(seed)
    assert np.array_equal(np.asarray(rk), pk.numpy())
    for num in (2, 3, (2, 3)):
        assert np.array_equal(np.asarray(jax.random.split(rk, num)), prng.split(pk, num).numpy())
    for data in (0, 1, 7, 2**31, 2**32 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(rk, np.uint32(data))),
                              prng.fold_in(pk, data).numpy())
    # the int32 datum -1 is folded in as 2^32 - 1, as the reference converts it
    assert torch.equal(prng.fold_in(pk, -1), prng.fold_in(pk, 2**32 - 1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES + [BIG], ids=str)
def test_bits_uniform_bernoulli_bit_for_bit(seed, shape):
    rk, pk = _k(seed)
    want = np.asarray(jax.random.bits(rk, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.bits(pk, shape).numpy(), want)
    u = prng.uniform(pk, shape).numpy()
    assert np.array_equal(u.view(np.int32), np.asarray(jax.random.uniform(rk, shape)).view(np.int32))
    v = prng.uniform(pk, shape, -2.5, 3.0).numpy()
    assert _ulps(v, jax.random.uniform(rk, shape, minval=-2.5, maxval=3.0)).max(initial=0) == 0
    assert np.array_equal(prng.bernoulli(pk, 0.3, shape).numpy(),
                          np.asarray(jax.random.bernoulli(rk, 0.3, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES + [BIG], ids=str)
def test_randint_bit_for_bit(seed, shape):
    rk, pk = _k(seed)
    spans = SPANS if shape != BIG else SPANS[:4]
    for lo, hi in spans:
        got = prng.randint(pk, shape, lo, hi)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(jax.random.randint(rk, shape, lo, hi))), (
            lo, hi)


@pytest.mark.parametrize("seed", SEEDS)
def test_choice_bit_for_bit(seed):
    rk, pk = _k(seed)
    for n, m in [(10, 3), (1000, 1000), (20000, 64)]:
        assert np.array_equal(prng.choice(pk, n, (m,), replace=False).numpy(),
                              np.asarray(jax.random.choice(rk, n, (m,), replace=False)))
        assert np.array_equal(prng.choice(pk, n, (m,)).numpy(),
                              np.asarray(jax.random.choice(rk, n, (m,))))
    assert np.array_equal(prng.permutation(pk, 777).numpy(),
                          np.asarray(jax.random.permutation(rk, 777)))
    # with p: equal where the float32 cumulative sums agree (a small, exact one here)
    p = np.array([1, 0, 3, 4, 0, 8], np.float32) / 16
    assert np.array_equal(prng.choice(pk, 6, (5, 4), p=torch.from_numpy(p)).numpy(),
                          np.asarray(jax.random.choice(rk, 6, (5, 4), p=jnp.asarray(p))))


def test_normal_within_its_bound_over_20_seeds():
    equal = total = 0
    for seed in SEEDS:
        rk, pk = _k(seed)
        for shape in SHAPES + [BIG]:
            d = _ulps(prng.normal(pk, shape).numpy(), jax.random.normal(rk, shape))
            assert d.max(initial=0) <= NORMAL_ULPS, (seed, shape)
            if shape == BIG:
                equal += int((d == 0).sum())
                total += d.size
    print(f"normal: {equal} of {total} draws of 2^20 bit-equal to jax.random.normal")
    assert equal >= total - 16


def test_erf_inv_on_the_whole_open_interval():
    # two million points of (-1, 1), nearer +-1 than normal's uniform reaches
    x = np.linspace(-1, 1, 2_000_001, dtype=np.float32)[1:-1]
    got = prng.erf_inv(torch.from_numpy(x.copy())).numpy()
    want = np.asarray(jax.jit(jax.scipy.special.erfinv)(x))
    assert _ulps(got, want).max() <= NORMAL_ULPS
    assert torch.isposinf(prng.erf_inv(torch.tensor([1.0]))).all()


def test_chunked_draws_equal_one_draw(monkeypatch):
    rk, pk = _k(3)
    whole = prng.normal(pk, (7, 300), mul=0.5).numpy()
    monkeypatch.setattr(prng, "CHUNK", 256)  # chunks that split rows
    out = torch.empty((7, 300), dtype=torch.bfloat16)
    prng.normal(pk, (7, 300), mul=0.5, out=out)
    assert torch.equal(out, torch.from_numpy(whole).to(torch.bfloat16))
    assert np.array_equal(prng.bits(pk, (5, 211)).numpy(),
                          np.asarray(jax.random.bits(rk, (5, 211), jnp.uint32)).astype(np.int64))


def test_meta_keys_give_shapes_only():
    k = prng.key(0, "meta")
    ks = prng.split(k, 3)
    assert ks.shape == (3, 2) and ks.device.type == "meta"
    z = prng.normal(ks[0], (4, 5), dtype=torch.bfloat16)
    assert z.shape == (4, 5) and z.dtype == torch.bfloat16 and z.device.type == "meta"
    assert prng.randint(prng.fold_in(k, 1), (3,), 0, 9).device.type == "meta"
