"""The xor+popcount baseline of the PyTorch port against the JAX reference.

On CPU tensors the port's ``binary_dot`` runs its plain version
(``binary_dot_ref``: unpack, level-weighted values, value product), which
is exact (see ``kernels/binary_dot/ref.py``), so it must be bit-identical
to the reference's Pallas kernel in interpret mode and to its oracle,
at n_levels {1, 2, 4} and m {32, 96, 128}. The bit planes must hold the
reference's uint32 words; ``binary_dot_search`` and ``FlatBitwise`` must
give the reference's scores and live ids at a ragged N with ties. The
CUDA kernel itself is held against the plain version by the ``gpu``
tests (on the card only) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.index import flat as RF  # noqa: E402
from repro.kernels.binary_dot import kernel as RK  # noqa: E402
from repro.kernels.binary_dot import ops as RO  # noqa: E402
from repro.kernels.binary_dot import ref as RR  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.index.flat import FlatBitwise  # noqa: E402
from repro_torch.kernels.binary_dot import kernel as PK  # noqa: E402
from repro_torch.kernels.binary_dot import ops as PO  # noqa: E402
from repro_torch.kernels.binary_dot import ref as PR  # noqa: E402

LEVELS = [1, 2, 4]
DIMS = [32, 96, 128]


def _codes(rng, shape, n_levels):
    return rng.integers(0, 2**n_levels, shape).astype(np.int8)


def _ref_planes(codes, n_levels):
    return np.asarray(RB.pack_bitplanes(RB.unpack_codes(jnp.asarray(codes), n_levels)))


def _bits(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("m", DIMS)
@pytest.mark.parametrize("n_levels", LEVELS)
def test_bitplanes_word_identical_to_reference(n_levels, m):
    rng = np.random.default_rng(10 * n_levels + m)
    codes = _codes(rng, (3, 7, m), n_levels)  # leading dims beyond one
    want = _ref_planes(codes, n_levels)
    bits = PB.unpack_codes(torch.from_numpy(codes), n_levels)
    got = PB.pack_bitplanes(bits)
    assert got.dtype == torch.int32 and got.shape == (3, 7, n_levels, m // 32)
    assert np.array_equal(_bits(got), want)
    for chunk in (1, 5, 1 << 20):  # the integer helper, in chunks of rows
        assert torch.equal(PB.pack_code_planes(torch.from_numpy(codes), n_levels, chunk=chunk),
                           got)
    ref_bits = np.asarray(RB.unpack_bitplanes(jnp.asarray(want), m))
    assert np.array_equal(PB.unpack_bitplanes(got, m).numpy(), ref_bits)
    assert torch.equal(PB.unpack_bitplanes(got, m), bits)


def test_bitplanes_use_the_sign_bit():
    """A word with bit 31 set is negative as int32 and round-trips exactly."""
    codes = np.full((2, 32), 1, np.int8)
    codes[0, 31] = 0
    got = PB.pack_code_planes(torch.from_numpy(codes), 1)
    assert _bits(got).tolist() == [[[0x7FFFFFFF]], [[0xFFFFFFFF]]]
    assert got[1, 0, 0] == -1
    assert np.array_equal(_bits(got), _ref_planes(codes, 1))


def test_bitplanes_reject_ragged_dims():
    with pytest.raises(ValueError):
        PB.pack_code_planes(torch.zeros((2, 48), dtype=torch.int8), 2)
    with pytest.raises(ValueError):
        PB.pack_bitplanes(torch.ones((2, 2, 40)))


@pytest.mark.parametrize("m", DIMS)
@pytest.mark.parametrize("n_levels", LEVELS)
def test_binary_dot_bit_identical_to_reference(n_levels, m):
    rng = np.random.default_rng(100 * n_levels + m)
    cq, cd = _codes(rng, (8, m), n_levels), _codes(rng, (64, m), n_levels)
    rq, rd = _ref_planes(cq, n_levels), _ref_planes(cd, n_levels)
    pq = PB.pack_code_planes(torch.from_numpy(cq), n_levels)
    pd = PB.pack_code_planes(torch.from_numpy(cd), n_levels)
    before = PK.binary_dot.launches
    got = PK.binary_dot(pq, pd, m=m)
    assert PK.binary_dot.launches == before  # the CPU path launches no kernel
    assert got.dtype == torch.float32 and got.shape == (8, 64)
    interp = np.asarray(RK.binary_dot(jnp.asarray(rq), jnp.asarray(rd), m=m, block_q=8,
                                      block_n=32, interpret=True))
    oracle = np.asarray(RR.binary_dot_ref(jnp.asarray(rq), jnp.asarray(rd), m))
    assert np.array_equal(interp.view(np.uint32), _bits(got))
    assert np.array_equal(oracle.view(np.uint32), _bits(got))


@pytest.mark.parametrize("n_levels", LEVELS)
def test_binary_dot_is_the_code_value_product(n_levels):
    """Eq. 11: the bitwise dot equals the grid-value dot, exactly."""
    rng = np.random.default_rng(n_levels)
    cq, cd = _codes(rng, (5, 128), n_levels), _codes(rng, (300, 128), n_levels)
    pq = PB.pack_code_planes(torch.from_numpy(cq), n_levels)
    pd = PB.pack_code_planes(torch.from_numpy(cd), n_levels)
    vq = PB.codes_to_values(torch.from_numpy(cq), n_levels).double()
    vd = PB.codes_to_values(torch.from_numpy(cd), n_levels).double()
    assert torch.equal(PK.binary_dot(pq, pd, m=128).double(), vq @ vd.t())


def test_plain_chunking_does_not_change_results():
    rng = np.random.default_rng(7)
    pq = PB.pack_code_planes(torch.from_numpy(_codes(rng, (6, 128), 4)), 4)
    pd = PB.pack_code_planes(torch.from_numpy(_codes(rng, (203, 128), 4)), 4)
    whole = PR.binary_dot_ref(pq, pd, 128)
    for chunk in (1, 7, 64):
        assert torch.equal(PR.binary_dot_ref(pq, pd, 128, chunk=chunk), whole)


def _search_inputs(n_levels, N=203, Q=5, m=64, seed=0):
    rng = np.random.default_rng(seed + n_levels)
    cq, cd = _codes(rng, (Q, m), n_levels), _codes(rng, (N, m), n_levels)
    cd[N // 2:] = cd[: N - N // 2]  # every document twice: tied scores
    return cq, cd


@pytest.mark.parametrize("n_levels", LEVELS)
def test_search_bit_identical_to_reference(n_levels):
    cq, cd = _search_inputs(n_levels)
    k = 12
    ref = RF.FlatBitwise.build(jnp.asarray(cd), n_levels, interpret=True)
    rv, ri = (np.asarray(x) for x in ref.search(jnp.asarray(cq), k))
    index = FlatBitwise.build(cd, n_levels, device="cpu")
    assert index.packed.device.type == "cpu" and index.m == 64
    assert np.array_equal(_bits(index.packed), np.asarray(ref.packed))
    assert index.nbytes() == ref.nbytes()
    v, i = index.search(cq, k)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert np.array_equal(rv.view(np.uint32), _bits(v))
    assert np.array_equal(ri, i.numpy())
    # the ops-level search and its plain twin, on the same planes
    pq = PB.pack_code_planes(torch.from_numpy(cq), n_levels)
    for fn in (PO.binary_dot_search, PO.binary_dot_search_torch):
        sv, si = fn(pq, index.packed, m=64, k=k)
        assert torch.equal(sv, v) and torch.equal(si, i)
    ov, oi = RO.binary_dot_search(jnp.asarray(_ref_planes(cq, n_levels)), ref.packed, m=64,
                                  k=k, interpret=True)
    assert np.array_equal(np.asarray(ov), v.numpy()) and np.array_equal(np.asarray(oi), i)
    # ties: each top score of a duplicated document comes with both copies, lower id first
    assert (np.diff(v.numpy(), axis=1) <= 0).all()
    tied = v.numpy()[:, 1:] == v.numpy()[:, :-1]
    assert tied.any() and (i.numpy()[:, 1:][tied] > i.numpy()[:, :-1][tied]).all()


@pytest.mark.parametrize("n_levels", [1, 4])
def test_k_greater_than_n(n_levels):
    """Live slots equal the reference's; the slots past N are (-1e30, -1),
    where the reference returns its padded columns' ids (ROADMAP queue 3)."""
    cq, cd = _search_inputs(n_levels, N=41, Q=3, m=32)
    k = 60
    rv, ri = (np.asarray(x) for x in
              RF.FlatBitwise.build(jnp.asarray(cd), n_levels).search(jnp.asarray(cq), k))
    v, i = FlatBitwise.build(cd, n_levels, device="cpu").search(cq, k)
    assert np.array_equal(rv.view(np.uint32), _bits(v))
    live = rv > -1e29
    assert live.sum(1).tolist() == [41] * 3
    assert np.array_equal(ri[live], i.numpy()[live])
    assert (i.numpy()[~live] == -1).all() and (v.numpy()[~live] == -1e30).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((2, 4, 4), dtype=torch.int32)
    d = torch.zeros((10, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        PK.binary_dot(q.to(torch.int64), d, m=128)
    with pytest.raises(ValueError):
        PK.binary_dot(q, d[:, :2], m=128)  # n_levels differ
    with pytest.raises(ValueError):
        PK.binary_dot(q, d, m=96)  # words do not match m
    with pytest.raises(ValueError):
        PK.binary_dot(q, d, m=100)
    with pytest.raises(ValueError):
        PK.binary_dot(q[0], d, m=128)
    with pytest.raises(ValueError):
        PO.binary_dot_search(q, d, m=128, k=0)


def test_only_vector_rows_need_alignment():
    """Rows whose word count is a multiple of 4 are read as 16-byte
    vectors and must start aligned; other rows are read word by word, so
    a row slice of the index (``packed[1:]``) is taken as it is."""
    PK._check_rows(torch.zeros((5, 1, 3), dtype=torch.int32)[1:])  # 12-byte rows
    PK._check_rows(torch.zeros((5, 1, 4), dtype=torch.int32)[1:])  # 16-byte rows
    off = torch.zeros(1 + 5 * 4, dtype=torch.int32)[1:]  # starts 4 bytes in
    PK._check_rows(off[:15].view(5, 1, 3))
    with pytest.raises(ValueError):
        PK._check_rows(off.view(5, 1, 4))
    with pytest.raises(ValueError):
        PK._check_rows(torch.zeros((5, 2, 4), dtype=torch.int32)[:, :1])  # not contiguous


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_levels", [1, 2, 3, 4])
@pytest.mark.parametrize("Q,N,m", [(64, 100_003, 128), (130, 3001, 32), (3, 257, 96),
                                   (17, 20_011, 256), (1, 1, 64)])
def test_kernel_matches_plain_on_card(n_levels, Q, N, m):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(Q * N + n_levels)
    cq = torch.randint(0, 2**n_levels, (Q, m), generator=gen, device=dev).to(torch.int8)
    cd = torch.randint(0, 2**n_levels, (N, m), generator=gen, device=dev).to(torch.int8)
    pq, pd = PB.pack_code_planes(cq, n_levels), PB.pack_code_planes(cd, n_levels)
    before = PK.binary_dot.launches
    got = PK.binary_dot(pq, pd, m=m)
    torch.cuda.synchronize()
    assert PK.binary_dot.launches == before + 1
    assert torch.equal(got, PR.binary_dot_ref(pq, pd, m))
    assert torch.equal(pq.cpu(), PB.pack_code_planes(cq.cpu(), n_levels))


@pytest.mark.gpu
def test_flat_bitwise_on_card_never_reaches_the_plain_version(monkeypatch):
    dev = _card()

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    cq, cd = _search_inputs(4, N=5003, Q=9, m=128)
    cv, ci = FlatBitwise.build(cd, 4, device="cpu").search(cq, 10)
    monkeypatch.setattr(PK, "binary_dot_ref", plain)
    index = FlatBitwise.build(cd, 4)
    assert index.packed.device.type == "cuda"
    before = PK.binary_dot.launches
    v, i = index.search(cq, 10)
    torch.cuda.synchronize()
    assert PK.binary_dot.launches == before + 1
    assert torch.equal(v.cpu(), cv) and torch.equal(i.cpu(), ci)


@pytest.mark.gpu
def test_kernel_raises_on_untaken_shape():
    dev = _card()
    q = torch.zeros((2, 5, 4), dtype=torch.int32, device=dev)  # n_levels 5
    with pytest.raises(ValueError):
        PK.binary_dot(q, q, m=128)


@pytest.mark.gpu
@pytest.mark.parametrize("n_levels,m", [(1, 96), (3, 32), (4, 128)])
def test_kernel_takes_a_row_slice_of_the_index(n_levels, m):
    """A sliced index at a word count not a multiple of 4 (12-byte rows at
    n_levels 1, m 96) runs on the scalar loads; at 16 words a one-row
    slice stays 16-byte aligned."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7 + n_levels)
    cq = torch.randint(0, 2**n_levels, (5, m), generator=gen, device=dev).to(torch.int8)
    cd = torch.randint(0, 2**n_levels, (1001, m), generator=gen, device=dev).to(torch.int8)
    pq = PB.pack_code_planes(cq, n_levels)
    pd = FlatBitwise.build(cd, n_levels).packed[1:]
    before = PK.binary_dot.launches
    got = PK.binary_dot(pq, pd, m=m)
    torch.cuda.synchronize()
    assert PK.binary_dot.launches == before + 1
    assert torch.equal(got, PR.binary_dot_ref(pq, pd, m))
