"""SDC top-k search of the PyTorch port against the JAX reference.

On CPU tensors the port's ``sdc_search``/``sdc_topk`` run the plain
version; fed the reference's inverse norms they must give bit-identical
scores and ids to the reference's Pallas kernel (interpret mode) and to
its ``sdc_search_xla``, across n_levels {1, 2, 4}, int8 and nibble-packed
codes, a corpus that is a multiple of no block, k > N, excluded
documents and ties. The unfused search (``fused=False``: the score
matrix of ``sdc_scores``, then a stable top-k) must give the same bits
as the reference's unfused search and as the port's fused one. The CUDA
kernels themselves are held against the plain versions by the ``gpu``
tests (on the card only) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.kernels.sdc import ops as RO  # noqa: E402
from repro.kernels.sdc import ref as RR  # noqa: E402
from repro.kernels.sdc import sdc as RS  # noqa: E402
from repro_torch.core.binarize_lib import pack_codes_nibbles  # noqa: E402
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
        PS.sdc_topk(q, d, inv, n_levels=4, k=PS.K_MAX + 1)
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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_levels", [1, 2, 4])
@pytest.mark.parametrize("Q,N,D,k", [(37, 100_003, 128, 10), (5, 50, 64, 100),
                                     (64, 30_011, 128, 1024), (3, 900, 32, PS.K_MAX)])
def test_kernel_matches_plain_on_card(packed, n_levels, Q, N, D, k):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(Q * N + n_levels)
    q = torch.randint(0, 2**n_levels, (Q, D), generator=gen, device=dev).to(torch.int8)
    d = torch.randint(0, 2**n_levels, (N, D), generator=gen, device=dev).to(torch.int8)
    d[N // 2:] = d[: N - N // 2].clone()
    inv = doc_inv_norms(d, n_levels)
    inv[-N // 5:] = 0
    dd = pack_codes_nibbles(d) if packed else d
    before = PS.sdc_topk.launches
    v, i = PS.sdc_topk(q, dd, inv, n_levels=n_levels, k=k, packed=packed)
    torch.cuda.synchronize()
    assert PS.sdc_topk.launches == before + 1
    pv, pi = PS.sdc_topk_torch(q, dd, inv, n_levels=n_levels, k=k, packed=packed)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.gpu
def test_kernel_raises_on_untaken_dim():
    dev = _card()
    q = torch.zeros((2, 48), dtype=torch.int8, device=dev)
    d = torch.zeros((10, 48), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        PS.sdc_topk(q, d, torch.ones(10, device=dev), n_levels=4, k=3)
