"""Code arithmetic of the PyTorch port against the JAX reference.

Every packing helper and the SDC affine epilogue must be bit-identical
to ``repro.core.binarize_lib`` on the same numpy inputs; ``doc_inv_norms``
is held to one ulp (XLA's CPU rsqrt is not correctly rounded, so the
port cannot match it bit for bit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.kernels.sdc import ref as RR  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.kernels.sdc import ref as PR  # noqa: E402


def _codes(seed, shape, n_levels):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**n_levels, shape).astype(np.int8)


def _bits(seed, shape):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _eq(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype)
    assert ref.shape == got.shape
    assert np.array_equal(ref.view(np.uint8), got.view(np.uint8))


@pytest.mark.parametrize("n_levels", [1, 2, 3, 4, 8])
def test_affine_constants_match(n_levels):
    assert PB.code_affine_constants(n_levels) == RB.code_affine_constants(n_levels)
    assert PB.SDC_NEG_INF == RB.SDC_NEG_INF


@pytest.mark.parametrize("n_levels", [1, 2, 4, 8])
def test_pack_and_unpack_codes_bit_identical(n_levels):
    bits = _bits(n_levels, (6, 5, n_levels, 32))
    _eq(RB.pack_codes(jnp.asarray(bits)), PB.pack_codes(torch.from_numpy(bits)))
    codes = np.array(RB.pack_codes(jnp.asarray(bits)))
    _eq(RB.unpack_codes(jnp.asarray(codes), n_levels),
        PB.unpack_codes(torch.from_numpy(codes), n_levels))


@pytest.mark.parametrize("n_levels", [1, 2, 4])
def test_values_roundtrip_bit_identical(n_levels):
    codes = _codes(n_levels, (40, 64), n_levels)
    ref_v = RB.codes_to_values(jnp.asarray(codes), n_levels)
    got_v = PB.codes_to_values(torch.from_numpy(codes), n_levels)
    _eq(ref_v, got_v)
    _eq(RB.values_to_codes(ref_v, n_levels), PB.values_to_codes(got_v, n_levels))


@pytest.mark.parametrize("coarse", [1, 2, 3, 4])
def test_coarse_codes_bit_identical(coarse):
    codes = _codes(coarse, (30, 32), 4)
    _eq(RB.coarse_codes(jnp.asarray(codes), 4, coarse),
        PB.coarse_codes(torch.from_numpy(codes), 4, coarse))
    with pytest.raises(ValueError):
        PB.coarse_codes(torch.from_numpy(codes), 4, 5)


@pytest.mark.parametrize("D", [2, 32, 128])
def test_nibble_packing_bit_identical(D):
    codes = _codes(D, (3, 17, D), 4)
    ref_p = RB.pack_codes_nibbles(jnp.asarray(codes))
    got_p = PB.pack_codes_nibbles(torch.from_numpy(codes))
    _eq(ref_p, got_p)
    p = np.array(ref_p)
    for r, g in zip(RB.unpack_nibble_planes(jnp.asarray(p)),
                    PB.unpack_nibble_planes(torch.from_numpy(p))):
        _eq(r, g)
    _eq(RB.unpack_codes_nibbles(jnp.asarray(p)), PB.unpack_codes_nibbles(torch.from_numpy(p)))
    assert np.array_equal(PB.unpack_codes_nibbles(got_p).numpy(), codes)


def test_nibble_packing_rejects_odd_dim():
    with pytest.raises(ValueError):
        PB.pack_codes_nibbles(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("n_levels", [1, 2, 3, 4])
@pytest.mark.parametrize("with_inv", [False, True])
def test_affine_epilogue_bit_identical(n_levels, with_inv):
    rng = np.random.default_rng(n_levels)
    D = 128
    top = (2**n_levels - 1)
    dot = rng.integers(0, top * top * D, (16, 50)).astype(np.int32)
    sums = rng.integers(0, 2 * top * D, (16, 50)).astype(np.int32)
    inv = rng.uniform(0.01, 1.0, (1, 50)).astype(np.float32) if with_inv else None
    ref = RB.sdc_affine_epilogue(jnp.asarray(dot), jnp.asarray(sums), dim=D, n_levels=n_levels,
                                 inv_norm=None if inv is None else jnp.asarray(inv))
    got = PB.sdc_affine_epilogue(torch.from_numpy(dot), torch.from_numpy(sums), dim=D,
                                 n_levels=n_levels,
                                 inv_norm=None if inv is None else torch.from_numpy(inv))
    _eq(ref, got)


@pytest.mark.parametrize("n_levels", [1, 2, 4])
def test_doc_inv_norms_within_one_ulp(n_levels):
    codes = _codes(10 + n_levels, (20000, 128), n_levels)
    ref = np.asarray(RR.doc_inv_norms(jnp.asarray(codes), n_levels))
    got = PR.doc_inv_norms(torch.from_numpy(codes), n_levels).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(ref), np.abs(got)))
    assert np.all(np.abs(ref - got) <= ulp)


@pytest.mark.parametrize("n_levels", [1, 2, 4])
def test_doc_inv_norms_correctly_rounded(n_levels):
    """The float32 root and quotient, each correctly rounded (numpy's float32
    sqrt and division are), so the CPU's bits are the card's."""
    codes = _codes(20 + n_levels, (20000, 128), n_levels)
    v = PB.codes_to_values(torch.from_numpy(codes), n_levels).numpy()
    s = (v * v).sum(-1, dtype=np.float32) + np.float32(1e-12)
    want = np.float32(1) / np.sqrt(s)
    got = PR.doc_inv_norms(torch.from_numpy(codes), n_levels).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_levels", [1, 4])
def test_sdc_oracles_match_reference(n_levels):
    q, d = _codes(1, (8, 64), n_levels), _codes(2, (90, 64), n_levels)
    inv = np.asarray(RR.doc_inv_norms(jnp.asarray(d), n_levels))
    ref_aff = RR.sdc_ref_affine(jnp.asarray(q), jnp.asarray(d), n_levels, jnp.asarray(inv))
    got_aff = PR.sdc_ref_affine(torch.from_numpy(q), torch.from_numpy(d), n_levels,
                                torch.from_numpy(inv))
    _eq(ref_aff, got_aff)  # exact integer products + the shared epilogue
    ref = RR.sdc_ref(jnp.asarray(q), jnp.asarray(d), n_levels, jnp.asarray(inv))
    got = PR.sdc_ref(torch.from_numpy(q), torch.from_numpy(d), n_levels, torch.from_numpy(inv))
    # float products summed in another order: float32 rounding only
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_code_dot_is_exact_and_bounded():
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, (7, 1023)).astype(np.int8)
    b = rng.integers(-128, 128, (9, 1023)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = PR.code_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        PR.code_dot(torch.zeros((1, 1024), dtype=torch.int8), torch.zeros((1, 1024), dtype=torch.int8))


def test_ste_sign_forward_matches():
    x = np.array([-2.0, -0.0, 0.0, 1e-30, 3.0], dtype=np.float32)
    _eq(RB.ste_sign(jnp.asarray(x)), PB.ste_sign(torch.from_numpy(x)))
