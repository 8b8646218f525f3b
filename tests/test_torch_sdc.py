"""SDC top-k search of the PyTorch port against the JAX reference.

On CPU tensors the port's ``sdc_search``/``sdc_topk`` run the plain
version; fed the reference's inverse norms they must give bit-identical
scores and ids to the reference's Pallas kernel (interpret mode) and to
its ``sdc_search_xla``, across n_levels {1, 2, 4}, int8 and nibble-packed
codes, a corpus that is a multiple of no block, k > N, excluded
documents and ties. The unfused search (``fused=False``: the score
matrix of ``sdc_scores``, then a stable top-k) must give the same bits
as the reference's unfused search and as the port's fused one. Code dims
8 and 16 (which the card pads to 32), 264 and 300 (above the fused
kernels' 256: the card's unfused route) and k = 5000 (past the fused
kernel's ``K_MAX``) must give the reference's bits too, through
``sdc_search``, ``FlatSDC``, ``unfused_topk`` and the score matrix: the
tolerance is zero throughout. The
CUDA kernels themselves are held against the plain versions by the
``gpu`` tests (on the card only) and by ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.index import flat as RF  # noqa: E402
from repro.kernels.sdc import ops as RO  # noqa: E402
from repro.kernels.sdc import ref as RR  # noqa: E402
from repro.kernels.sdc import sdc as RS  # noqa: E402
from repro_torch.core.binarize_lib import pack_codes_nibbles  # noqa: E402
from repro_torch.index import flat as PF  # noqa: E402
from repro_torch.kernels.sdc import ops as PO  # noqa: E402
from repro_torch.kernels.sdc import sdc as PS  # noqa: E402
from repro_torch.kernels.sdc.defaults import BlockPlan  # noqa: E402
from repro_torch.kernels.sdc.ref import doc_inv_norms  # noqa: E402

# (Q, N, k, what): N = 203 is a multiple of no block.
CASES = {
    "ragged": (5, 203, 7),
    "k_gt_n": (3, 41, 60),
    "excluded": (6, 203, 9),
    "ties": (4, 203, 12),
}


def _inputs(case, n_levels, packed, D=64):
    Q, N, k = CASES[case]
    rng = np.random.default_rng(100 * sorted(CASES).index(case) + 10 * n_levels + packed)
    q = rng.integers(0, 2**n_levels, (Q, D)).astype(np.int8)
    d = rng.integers(0, 2**n_levels, (N, D)).astype(np.int8)
    if case == "ties":
        d[N // 2:] = d[: N - N // 2]  # every doc twice: equal scores
    inv = np.array(RR.doc_inv_norms(jnp.asarray(d), n_levels))
    if case == "excluded":
        inv[::3] = 0.0
        inv[-40:] = 0.0
    dd = np.array(RB.pack_codes_nibbles(jnp.asarray(d))) if packed else d
    return q, dd, inv, k


def _same(ref, got):
    rv, ri = (np.asarray(x) for x in ref)
    gv, gi = (x.numpy() for x in got)
    assert gv.dtype == np.float32 and gi.dtype == np.int32
    assert np.array_equal(rv.view(np.uint32), gv.view(np.uint32))
    assert np.array_equal(ri, gi)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_levels", [1, 2, 4])
def test_sdc_search_bit_identical_to_reference(case, packed, n_levels):
    q, dd, inv, k = _inputs(case, n_levels, packed)
    got = PO.sdc_search(torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv),
                        n_levels=n_levels, k=k, packed=packed)
    ref_interp = RO.sdc_search(jnp.asarray(q), jnp.asarray(dd), jnp.asarray(inv),
                               n_levels=n_levels, k=k, block_q=8, block_n=64,
                               interpret=True, packed=packed)
    ref_xla = RO.sdc_search_xla(jnp.asarray(q), jnp.asarray(dd), jnp.asarray(inv),
                                n_levels=n_levels, k=k, packed=packed)
    _same(ref_interp, got)
    _same(ref_xla, got)
    v, i = got
    if case == "k_gt_n":
        assert (i[:, CASES[case][1]:] == -1).all()
        assert (v[:, CASES[case][1]:] == RB.SDC_NEG_INF).all()
    if case == "excluded":
        assert not np.isin(i.numpy(), np.flatnonzero(inv == 0)).any()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_levels", [1, 4])
def test_unfused_search_bit_identical_to_reference_and_fused(case, packed, n_levels):
    q, dd, inv, k = _inputs(case, n_levels, packed)
    args = (torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv))
    before = PS.sdc_scores.launches
    got = PO.sdc_search(*args, n_levels=n_levels, k=k, packed=packed, fused=False)
    assert PS.sdc_scores.launches == before  # the CPU path launches no kernel
    ref = RO.sdc_search(jnp.asarray(q), jnp.asarray(dd), jnp.asarray(inv), n_levels=n_levels,
                        k=k, block_q=8, block_n=64, interpret=True, fused=False, packed=packed)
    _same(ref, got)
    fused = PO.sdc_search(*args, n_levels=n_levels, k=k, packed=packed)
    assert torch.equal(fused[0], got[0]) and torch.equal(fused[1], got[1])
    via = PO.sdc_search_backend(*args, n_levels=n_levels, k=k, packed=packed, fused=False,
                                backend="torch")
    assert torch.equal(via[0], got[0]) and torch.equal(via[1], got[1])


@pytest.mark.parametrize("packed", [False, True])
def test_score_matrix_bit_identical_to_reference(packed):
    q, dd, inv, _ = _inputs("excluded", 4, packed)
    q, dd, inv = q[:4], dd[:192], inv[:192]  # whole tiles for the reference kernel
    ref = RS.sdc_scores(jnp.asarray(q), jnp.asarray(dd), jnp.asarray(inv), n_levels=4,
                        block_q=4, block_n=64, interpret=True, packed=packed)
    got = PS.sdc_scores(torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv),
                        n_levels=4, packed=packed)
    assert np.array_equal(np.asarray(ref).view(np.uint32), got.numpy().view(np.uint32))
    assert (got.numpy()[:, inv == 0] == RB.SDC_NEG_INF).all()
    part = PS.sdc_scores_torch(torch.from_numpy(q), torch.from_numpy(dd),
                               torch.from_numpy(inv), n_levels=4, packed=packed, chunk=50)
    assert torch.equal(got, part)


@pytest.mark.parametrize("packed", [False, True])
def test_plain_chunking_does_not_change_results(packed):
    q, dd, inv, k = _inputs("ties", 4, packed)
    args = (torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv))
    whole = PS.sdc_topk_torch(*args, n_levels=4, k=k, packed=packed)
    for chunk in (1, 7, 64):
        part = PS.sdc_topk_torch(*args, n_levels=4, k=k, packed=packed, chunk=chunk)
        assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])


@pytest.mark.parametrize("k", [1, 10, 70, 300])
def test_chunked_selection_equals_one_sort(monkeypatch, k):
    """A sharded step's top k (``select_topk`` on a DTensor) selects a
    chunk of columns at a time: the same scores and ids as one stable sort,
    ties (few distinct scores, -0.0 beside 0.0, excluded documents) going to
    the lower column across chunks, and k past the columns padded."""
    monkeypatch.setattr(PS, "_TOPK_SELECT_CHUNK", 64)
    rng = np.random.default_rng(3)
    scores = torch.from_numpy(rng.integers(-3, 4, (5, 250)).astype(np.float32) * 0.5)
    scores[1, 10:20], scores[1, 70:80] = -0.0, 0.0  # in two chunks
    scores[:, ::9] = RB.SDC_NEG_INF
    got, want = PS._chunked_topk(scores, k), PS.select_topk(scores, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_backend_dispatch_on_cpu(backend):
    q, dd, inv, k = _inputs("ragged", 4, False)
    args = (torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv))
    want = PO.sdc_search_torch(*args, n_levels=4, k=k)
    before = PS.sdc_topk.launches
    plan = BlockPlan("scan", 16, 1024, "tuned")
    got = PO.sdc_search_backend(*args, n_levels=4, k=k, backend=backend, block_plan=plan)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert PS.sdc_topk.launches == before  # the CPU path launches no kernel


def test_resolve_backend_follows_the_device():
    assert PO.resolve_backend("auto", "cpu") == "torch"
    assert PO.resolve_backend("auto", "cuda") == "cuda"
    assert PO.resolve_backend("torch", "cuda") == "torch"  # asked for explicitly
    with pytest.raises(ValueError):
        PO.resolve_backend("cuda", "cpu")  # no silent switch to the plain version
    with pytest.raises(ValueError):
        PO.resolve_backend("xla", "cpu")
    with pytest.raises(ValueError):
        PO.resolve_backend("auto")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((2, 64), dtype=torch.int8)
    d = torch.zeros((10, 64), dtype=torch.int8)
    inv = torch.ones(10)
    with pytest.raises(ValueError):
        PS.sdc_topk(q, d, inv, n_levels=4, k=0)
    with pytest.raises(ValueError):
        PS.sdc_topk(q.to(torch.int32), d, inv, n_levels=4, k=3)
    with pytest.raises(ValueError):
        PS.sdc_topk(q, d, inv, n_levels=4, k=3, packed=True)  # int8 corpus, packed flag
    with pytest.raises(ValueError):
        PS.sdc_topk(q, d[:, :32], inv, n_levels=4, k=3)
    with pytest.raises(ValueError):
        PS.sdc_topk(q, d, inv.double(), n_levels=4, k=3)
    with pytest.raises(ValueError):
        PS.sdc_topk(q, d, inv[:5], n_levels=4, k=3)


def test_largest_k_is_served():
    q, dd, inv, _ = _inputs("ragged", 4, False)
    v, i = PS.sdc_topk(torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv),
                       n_levels=4, k=PS.K_MAX)
    assert v.shape == (q.shape[0], PS.K_MAX)
    assert (i[:, dd.shape[0]:] == -1).all()


# (D, Q, N, k): code dims off the kernel widths, above the fused kernels'
# widest (264, 300), and k past K_MAX.
SHAPES = {"dim8": (8, 5, 203, 7), "dim16": (16, 6, 311, 12), "k5000": (16, 3, 6007, 5000),
          "dim264": (264, 4, 203, 9), "dim300": (300, 3, 211, 12)}


def _shape_inputs(shape, n_levels, packed):
    D, Q, N, k = SHAPES[shape]
    rng = np.random.default_rng(1000 + 10 * sorted(SHAPES).index(shape) + packed)
    q = rng.integers(0, 2**n_levels, (Q, D)).astype(np.int8)
    d = rng.integers(0, 2**n_levels, (N, D)).astype(np.int8)
    d[N // 2:N // 2 + 40] = d[:40]  # equal scores
    inv = np.array(RR.doc_inv_norms(jnp.asarray(d), n_levels))
    inv[::11] = 0.0
    dd = np.array(RB.pack_codes_nibbles(jnp.asarray(d))) if packed else d
    return q, d, dd, inv, k


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("packed", [False, True])
def test_search_matches_reference_off_kernel_dims_and_past_k_max(shape, packed):
    n_levels = 2
    q, d, dd, inv, k = _shape_inputs(shape, n_levels, packed)
    ref = RO.sdc_search_backend(jnp.asarray(q), jnp.asarray(dd), jnp.asarray(inv),
                                n_levels=n_levels, k=k, packed=packed, backend="xla")
    args = (torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv))
    before = PS.sdc_topk.launches
    _same(ref, PO.sdc_search(*args, n_levels=n_levels, k=k, packed=packed))
    _same(ref, PO.sdc_search_backend(*args, n_levels=n_levels, k=k, packed=packed))
    assert PS.sdc_topk.launches == before  # the CPU path launches no kernel
    # FlatSDC with the reference's inverse norms handed over
    ref_index = RF.FlatSDC.build(jnp.asarray(d), n_levels, packed=packed, backend="xla")
    index = PF.FlatSDC(codes=torch.from_numpy(np.array(ref_index.codes)),
                       inv_norm=torch.from_numpy(np.array(ref_index.inv_norm)),
                       n_levels=n_levels, packed=packed)
    _same(ref_index.search(jnp.asarray(q), k), index.search(torch.from_numpy(q), k))
    # the route the card takes past K_MAX or above code dim 256, on the plain scores
    _same(ref, PS.unfused_topk(PS.sdc_scores, *args, n_levels=n_levels, k=k, packed=packed))


@pytest.mark.parametrize("D_", [264, 300])
@pytest.mark.parametrize("packed", [False, True])
def test_score_matrix_matches_reference_above_the_fused_dims(D_, packed):
    rng = np.random.default_rng(D_ + packed)
    q = rng.integers(0, 16, (4, D_)).astype(np.int8)
    d = rng.integers(0, 16, (128, D_)).astype(np.int8)
    inv = np.array(RR.doc_inv_norms(jnp.asarray(d), 4))
    inv[::9] = 0.0
    dd = np.array(RB.pack_codes_nibbles(jnp.asarray(d))) if packed else d
    ref = RS.sdc_scores(jnp.asarray(q), jnp.asarray(dd), jnp.asarray(inv), n_levels=4,
                        block_q=4, block_n=64, interpret=True, packed=packed)
    got = PS.sdc_scores(torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv),
                        n_levels=4, packed=packed)
    assert np.array_equal(np.asarray(ref).view(np.uint32), got.numpy().view(np.uint32))
    assert (got.numpy()[:, inv == 0] == RB.SDC_NEG_INF).all()


def test_scores_dim_pads_to_a_multiple_of_32():
    assert [PS.scores_dim(D) for D in (1, 32, 33, 200, 256, 264, 300, 512)] == \
        [32, 32, 64, 224, 256, 288, 320, 512]
    q = torch.ones((2, 300), dtype=torch.int8)
    qa, qb, dk = PS.kernel_operands(q, q[[1, 0, 1]], packed=False, width=PS.scores_dim(300))
    assert qa.shape == (2, 320) and dk.shape == (3, 320) and not dk[:, 300:].any()


def test_unfused_query_chunks_do_not_change_results(monkeypatch):
    q, dd, inv, k = _inputs("ties", 4, True)
    args = (torch.from_numpy(q), torch.from_numpy(dd), torch.from_numpy(inv))
    whole = PS.unfused_topk(PS.sdc_scores, *args, n_levels=4, k=k, packed=True)
    monkeypatch.setattr(PS, "query_chunk", lambda device, Q, per_query: 3)
    part = PS.unfused_topk(PS.sdc_scores, *args, n_levels=4, k=k, packed=True)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])


def test_kernel_dim_pads_to_the_next_width():
    assert [PS.kernel_dim(D) for D in (1, 8, 16, 32, 48, 64, 96, 128, 200, 256)] == \
        [32, 32, 32, 32, 64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError):
        PS.kernel_dim(264)
    q = torch.arange(2 * 10, dtype=torch.int8).reshape(2, 10) % 16
    d = q[[1, 0, 1]]
    qa, qb, dk = PS.kernel_operands(q, d, packed=False)
    assert qa.shape == (2, 32) and qb is qa and dk.shape == (3, 32)
    assert torch.equal(qa[:, :10], q) and not qa[:, 10:].any() and not dk[:, 10:].any()
    pd = pack_codes_nibbles(d)
    qa, qb, pk = PS.kernel_operands(q, pd, packed=True)
    assert qa.shape == qb.shape == (2, 16) and pk.shape == (3, 16)
    assert torch.equal(qa[:, :5], q[:, 0::2]) and torch.equal(qb[:, :5], q[:, 1::2])
    assert not qa[:, 5:].any() and not qb[:, 5:].any() and not pk[:, 5:].any()
    q32 = torch.zeros((2, 32), dtype=torch.int8)
    d32 = torch.zeros((3, 32), dtype=torch.int8)
    qa, _, dk = PS.kernel_operands(q32, d32, packed=False)
    assert dk is d32  # a kernel width takes no copy


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# Q, N, D, k: query chunks of either block shape cut at 1, 15, 16, 17, 64 and
# 65 queries, N a multiple of neither 128 nor 256, code dims the wrapper pads
# (16, 48) beside 32 and 256, k = 1 and K_MAX, and k = 5000 and code dims 264,
# 300 and 512 (the unfused route: the sdc_scores kernel and a stable sort).
CARD_CASES = [(37, 100_003, 128, 10), (5, 50, 64, 100), (64, 30_011, 128, 1024),
              (3, 900, 32, PS.K_MAX), (1, 10_007, 128, 10), (15, 10_007, 128, 10),
              (16, 33_001, 128, 10), (17, 33_001, 64, 10), (64, 50_003, 128, 10),
              (65, 50_003, 128, 10), (7, 20_011, 16, 10), (9, 20_011, 48, 33),
              (33, 20_011, 32, 10), (33, 20_011, 256, 10), (5, 3_001, 128, 1),
              (3, 9_001, 128, PS.K_MAX), (3, 9_001, 16, 5000), (9, 10_007, 264, 10),
              (5, 4_099, 300, 33), (3, 3_001, 512, 10)]
# every fused width at k 1 to K_MAX over a corpus that is a multiple of no
# round, 37 queries (chunks cut at 16 and 5)
CARD_CASES += [(37, 30_011, D, k) for D in PS.KERNEL_DIMS for k in (1, 10, 160, PS.K_MAX)]


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_levels", [1, 2, 4])
@pytest.mark.parametrize("Q,N,D,k", CARD_CASES)
def test_kernel_matches_plain_on_card(packed, n_levels, Q, N, D, k):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(Q * N + n_levels)
    q = torch.randint(0, 2**n_levels, (Q, D), generator=gen, device=dev).to(torch.int8)
    d = torch.randint(0, 2**n_levels, (N, D), generator=gen, device=dev).to(torch.int8)
    d[N // 2:] = d[: N - N // 2].clone()
    inv = doc_inv_norms(d, n_levels)
    inv[-N // 5:] = 0
    dd = pack_codes_nibbles(d) if packed else d
    fused = k <= PS.K_MAX and D <= 256  # else: sdc_scores and a stable sort
    before = (PS.sdc_topk.launches, PS.sdc_scores.launches)
    v, i = PS.sdc_topk(q, dd, inv, n_levels=n_levels, k=k, packed=packed)
    torch.cuda.synchronize()
    assert (PS.sdc_topk.launches, PS.sdc_scores.launches) == \
        (before[0] + fused, before[1] + (not fused))
    pv, pi = PS.sdc_topk_torch(q, dd, inv, n_levels=n_levels, k=k, packed=packed)
    assert torch.equal(v, pv) and torch.equal(i, pi)


def _holes(N: int, k: int, kind: str, device) -> torch.Tensor:
    """Rows to exclude inside the first round's parts: below k = 128 the
    kernel offers a block's first round in parts of cap = cap_for(k) < 256
    rows. "alternate" drops every other row; "runs" leaves the first part
    of each pair of parts a quarter of its rows (no buffer is cut after
    it) and the second all of them (its buffer overflows)."""
    n = torch.arange(N, device=device)
    if kind == "alternate":
        return n % 2 == 0
    part = min(PS.cap_for(k), 256)
    return n % (2 * part) < part - part // 4


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [10, 33])
@pytest.mark.parametrize("holes", ["alternate", "runs"])
def test_kernel_matches_plain_with_interleaved_exclusions(packed, k, holes):
    dev = _card()
    Q, N, n_levels = 17, 50_003, 4
    gen = torch.Generator(device=dev).manual_seed(N + k)
    q = torch.randint(0, 2**n_levels, (Q, 128), generator=gen, device=dev).to(torch.int8)
    d = torch.randint(0, 2**n_levels, (N, 128), generator=gen, device=dev).to(torch.int8)
    inv = doc_inv_norms(d, n_levels)
    inv[_holes(N, k, holes, dev)] = 0
    dd = pack_codes_nibbles(d) if packed else d
    before = PS.sdc_topk.launches
    v, i = PS.sdc_topk(q, dd, inv, n_levels=n_levels, k=k, packed=packed)
    torch.cuda.synchronize()
    assert PS.sdc_topk.launches == before + 1
    pv, pi = PS.sdc_topk_torch(q, dd, inv, n_levels=n_levels, k=k, packed=packed)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.gpu
def test_wide_dims_take_the_unfused_route_on_card():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(264)
    q = torch.randint(0, 16, (2, 264), generator=gen, device=dev).to(torch.int8)
    d = torch.randint(0, 16, (10, 264), generator=gen, device=dev).to(torch.int8)
    inv = doc_inv_norms(d, 4)
    before = (PS.sdc_topk.launches, PS.sdc_scores.launches)
    v, i = PS.sdc_topk(q, d, inv, n_levels=4, k=3)  # above the widest fused kernel
    torch.cuda.synchronize()
    assert (PS.sdc_topk.launches, PS.sdc_scores.launches) == (before[0], before[1] + 1)
    pv, pi = PS.sdc_topk_torch(q, d, inv, n_levels=4, k=3)
    assert torch.equal(v, pv) and torch.equal(i, pi)


# The scan's float gate (csrc/sdc_topk.cu): a pair becomes a key only where
# its score is not below the query's running k-th best. The cases below hold
# the kernel to the plain version bit for bit where the gate is at its edges.


def _held(q, d, inv, *, n_levels, k, packed):
    """Run the kernel once and hold it, scores bit for bit and ids, to the
    plain version; returns the gate's (pairs, passed) of the call."""
    before = PS.sdc_topk.gate_counts(q.device)
    launches = PS.sdc_topk.launches
    v, i = PS.sdc_topk(q, d, inv, n_levels=n_levels, k=k, packed=packed)
    after = PS.sdc_topk.gate_counts(q.device)
    assert PS.sdc_topk.launches == launches + 1
    pv, pi = PS.sdc_topk_torch(q, d, inv, n_levels=n_levels, k=k, packed=packed)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
    return after[0] - before[0], after[1] - before[1]


def _codes(gen, shape, n_levels, dev):
    return torch.randint(0, 2**n_levels, shape, generator=gen, device=dev).to(torch.int8)


def _packed(d, packed):
    return pack_codes_nibbles(d) if packed else d


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [1, 10, 160])
def test_gate_with_duplicate_rows_straddling_thresholds(packed, k):
    """50 distinct rows repeated over 70,001 ids: every score has about
    1,400 equal copies, across rounds of 256 rows and across slices, so a
    query's k-th best is tied with rows on both sides of it; ties go to
    the lower id."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(50 + k)
    Q, N, n_levels = 23, 70_001, 4
    q = _codes(gen, (Q, 128), n_levels, dev)
    distinct = _codes(gen, (50, 128), n_levels, dev)
    d = distinct[torch.randint(0, 50, (N,), generator=gen, device=dev)]
    _held(q, _packed(d, packed), doc_inv_norms(d, n_levels), n_levels=n_levels, k=k,
          packed=packed)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [10, 160, 1000])
def test_gate_with_zero_and_negative_scores(packed, k):
    """n_levels 1 (codes as -1/+1): every row is query 0's complement with up
    to 16 of 32 dims flipped back, so query 0's scores are all negative or
    exactly zero and its threshold settles at or below 0; the other queries
    see the same rows at random. (No score is -0.0: a sum that cancels
    exactly rounds to +0, and a kept row's norm is positive.)"""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1 + k)
    Q, N, D, n_levels = 9, 20_011, 32, 1
    q = _codes(gen, (Q, D), n_levels, dev)
    flips = torch.rand((N, D), generator=gen, device=dev).argsort(dim=1)
    back = flips < torch.randint(0, 17, (N, 1), generator=gen, device=dev)
    d = torch.where(back, q[0], 1 - q[0]).to(torch.int8)
    inv = doc_inv_norms(d, n_levels)
    v, _ = PS.sdc_topk_torch(q[:1], d, inv, n_levels=n_levels, k=N)
    assert (v[0] <= 0).all() and (v[0] == 0).sum() > k
    _held(q, _packed(d, packed), inv, n_levels=n_levels, k=k, packed=packed)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [10, 160])
def test_gate_with_zero_inverse_norms(packed, k):
    """Excluded rows (inverse norm 0 or -0.0) as single rows, as whole
    rounds of 256 and as most of a slice; they are never offered."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7 + k)
    Q, N, n_levels = 17, 60_007, 4
    q = _codes(gen, (Q, 64), n_levels, dev)
    d = _codes(gen, (N, 64), n_levels, dev)
    inv = doc_inv_norms(d, n_levels)
    inv[::7] = 0.0
    inv[3::11] = -0.0
    inv[512:1024] = 0.0
    inv[N // 2:N // 2 + 20_000] = 0.0
    pairs, passed = _held(q, _packed(d, packed), inv, n_levels=n_levels, k=k, packed=packed)
    assert pairs == Q * N and passed <= Q * int((inv > 0).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("Q,N,k", [(17, 150, 160), (3, 5, 10), (33, 1_000, PS.K_MAX)])
def test_gate_open_while_queries_hold_fewer_than_k(packed, Q, N, k):
    """N < k: no query ever holds k keys, so the threshold stays -inf and
    every valid pair passes the gate."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(Q * N)
    q = _codes(gen, (Q, 128), 4, dev)
    d = _codes(gen, (N, 128), 4, dev)
    inv = doc_inv_norms(d, 4)
    inv[::4] = 0.0
    pairs, passed = _held(q, _packed(d, packed), inv, n_levels=4, k=k, packed=packed)
    assert pairs == Q * N and passed == Q * int((inv > 0).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [10, 160])
def test_gate_with_scores_rising_with_the_id(packed, k):
    """One query 16 times over a corpus sorted by its score: each row is at
    least as good as every earlier one, so every pair past a block's first
    round passes the gate, and buffers overflow every round."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(k)
    N, n_levels = 400_009, 4
    q = _codes(gen, (1, 128), n_levels, dev).expand(16, -1).contiguous()
    d = _codes(gen, (N, 128), n_levels, dev)
    inv = doc_inv_norms(d, n_levels)
    s = PS.sdc_scores_torch(q[:1], d, inv, n_levels=n_levels)[0]
    order = torch.sort(s, stable=True).indices
    d, inv = d[order].contiguous(), inv[order].contiguous()
    pairs, passed = _held(q, _packed(d, packed), inv, n_levels=n_levels, k=k, packed=packed)
    _, n_slices, _ = PS.sdc_topk.last_geometry
    assert pairs == 16 * N and passed >= 16 * (N - 256 * n_slices) > 0


@pytest.mark.gpu
def test_gate_counts_pairs_and_passes():
    """gate_counts: pairs = Q * N exactly; the pairs past the gate are at
    least the keys each query's top k needs and, on a clustered corpus,
    a small share of the pairs."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    Q, N, k, n_levels = 64, 500_009, 10, 4
    centers = _codes(gen, (8, 128), n_levels, dev)
    d = centers[torch.randint(0, 8, (N,), generator=gen, device=dev)]
    noise = torch.randint(-2, 3, d.shape, generator=gen, device=dev)
    d = (d.to(torch.int32) + noise).clamp(0, 15).to(torch.int8)
    q = d[torch.randint(0, N, (Q,), generator=gen, device=dev)].clone()
    inv = doc_inv_norms(d, n_levels)
    pairs, passed = _held(q, pack_codes_nibbles(d), inv, n_levels=n_levels, k=k, packed=True)
    assert pairs == Q * N
    assert Q * k <= passed < 0.05 * pairs


@pytest.mark.parametrize("n_levels", [1, 2, 3, 4])
def test_epilogue_constant_is_positive(n_levels):
    """The gate's -0.0 edge cannot arise: the kernel adds c3 = D*beta^2 to
    every sum before the norm, so a sum is -0.0 only where both are, and
    c3 is +0.0 or positive at every level count and kernel width."""
    for D in PS.KERNEL_DIMS:
        c3 = PS.affine_terms(n_levels, D)[2]
        assert c3 > 0 or (c3 == 0 and math.copysign(1.0, c3) == 1.0)


def test_gate_counts_stay_zero_off_the_card():
    """The counters count only the kernel's launches: a CPU call runs the
    plain version and leaves a CPU device's counts at zero."""
    q = torch.randint(0, 16, (3, 64), dtype=torch.int8)
    d = torch.randint(0, 16, (300, 64), dtype=torch.int8)
    PS.sdc_topk(q, d, doc_inv_norms(d, 4), n_levels=4, k=5)
    assert PS.sdc_topk.gate_counts("cpu") == (0, 0)
    assert PS.sdc_topk.gate_counts(torch.device("cpu")) == (0, 0)
