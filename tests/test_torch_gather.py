"""Gather search of probed lists, PyTorch port against the JAX reference.

On CPU tensors the port's ``sdc_gather_topk`` runs its plain version,
``sdc_gather_topk_torch``. Fed the same lists, it must give scores
bitwise equal to the reference's jnp twin ``sdc_gather_topk_xla`` and to
its Pallas kernel in interpret mode, and ids equal to the twin's
everywhere and to the kernel's on every slot that holds a candidate (the
Pallas kernel reports the real ids of masked slots beside their
``-1e30``; the contract, the twin and the port say -1). Covered: n_levels
{1, 2, 4}, int8 and nibble-packed lists, padding, probes out of range on
both sides, ``k > nprobe * L``, a mask leaving fewer than k live slots,
everything masked, and equal scores in two probed lists where the later
list holds the lower id (the order is by slot, not by id). The CUDA
kernel is held against the plain version by the ``gpu`` tests (on the
card only) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.kernels.sdc import gather as RG  # noqa: E402
from repro.kernels.sdc import ref as RR  # noqa: E402
from repro_torch.core.binarize_lib import SDC_NEG_INF, pack_codes_nibbles  # noqa: E402
from repro_torch.kernels.sdc import gather as PG  # noqa: E402
from repro_torch.kernels.sdc import ops as PO  # noqa: E402
from repro_torch.kernels.sdc import sdc as PS  # noqa: E402
from repro_torch.kernels.sdc.ref import doc_inv_norms  # noqa: E402

NLIST, L, D, Q, NPROBE = 6, 40, 64, 5, 4
# case -> k
CASES = {"padded_out_of_range": 10, "k_gt_slots": 200, "partial_mask": 12,
         "all_masked": 5, "ties_across_lists": 9}


def _inputs(case, n_levels, packed):
    rng = np.random.default_rng(10 * sorted(CASES).index(case) + 2 * n_levels + packed)
    codes = rng.integers(0, 2**n_levels, (NLIST, L, D)).astype(np.int8)
    if case == "ties_across_lists":
        codes[:] = codes[0]  # every list a copy of list 0: equal scores across lists
        ids = ((NLIST - 1 - np.arange(NLIST))[:, None] * L + np.arange(L)).astype(np.int32)
    else:
        ids = rng.permutation(NLIST * L).astype(np.int32).reshape(NLIST, L)
    inv = np.array(RR.doc_inv_norms(jnp.asarray(codes.reshape(-1, D)), n_levels))
    inv = inv.reshape(NLIST, L)
    inv[:, -3:] = 0.0  # list padding: inv 0 and id -1 together
    ids[:, -3:] = -1
    q = rng.integers(0, 2**n_levels, (Q, D)).astype(np.int8)
    if case == "ties_across_lists":
        probes = np.stack([rng.permutation(NLIST)[:NPROBE] for _ in range(Q)])
    else:
        probes = rng.integers(-3, NLIST + 3, (Q, NPROBE))  # clamped into range
    mask = None
    if case == "partial_mask":
        mask = (rng.random((Q, NPROBE, L)) > 0.95).astype(np.float32)
    elif case == "all_masked":
        mask = np.zeros((Q, NPROBE, L), np.float32)
    lc = np.array(RB.pack_codes_nibbles(jnp.asarray(codes))) if packed else codes
    return q, lc, inv, ids, probes.astype(np.int32), mask, CASES[case]


def _port(q, lc, inv, ids, probes, mask, **kw):
    t = (torch.from_numpy(a) for a in (q, lc, inv, ids, probes))
    m = None if mask is None else torch.from_numpy(mask)
    v, i = PG.sdc_gather_topk(*t, cand_mask=m, **kw)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    return v.numpy(), i.numpy()


def _ref(fn, q, lc, inv, ids, probes, mask, **kw):
    m = None if mask is None else jnp.asarray(mask)
    v, i = fn(*map(jnp.asarray, (q, lc, inv, ids, probes)), cand_mask=m, **kw)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_levels", [1, 2, 4])
def test_gather_bit_identical_to_reference(case, packed, n_levels):
    *args, mask, k = _inputs(case, n_levels, packed)
    kw = dict(n_levels=n_levels, k=k, packed=packed)
    pv, pi = _port(*args, mask, **kw)
    xv, xi = _ref(RG.sdc_gather_topk_xla, *args, mask, **kw)
    kv, ki = _ref(RG.sdc_gather_topk, *args, mask, interpret=True, **kw)
    assert np.array_equal(pv.view(np.uint32), xv.view(np.uint32))
    assert np.array_equal(pv.view(np.uint32), kv.view(np.uint32))
    assert np.array_equal(pi, xi)
    live = pv > SDC_NEG_INF / 2
    assert np.array_equal(pi[live], ki[live])
    assert (pi[~live] == -1).all()
    if case == "k_gt_slots":
        assert (pi[:, NPROBE * L:] == -1).all()
    if case == "all_masked":
        assert not live.any()
    if case == "partial_mask":
        assert (live.sum(1) < k).any()  # fewer than k live slots for some query


def test_ties_go_to_the_earlier_probe_not_the_lower_id():
    # two lists of one identical document; the later probed list holds the lower id
    codes = np.full((2, 1, 32), 3, np.int8)
    inv = np.array(RR.doc_inv_norms(jnp.asarray(codes[:, 0]), 2)).reshape(2, 1)
    ids = np.array([[7], [2]], np.int32)
    probes = np.array([[0, 1], [1, 0]], np.int32)
    q = np.full((2, 32), 1, np.int8)
    pv, pi = _port(q, codes, inv, ids, probes, None, n_levels=2, k=2)
    assert pv[0, 0] == pv[0, 1]
    assert pi.tolist() == [[7, 2], [2, 7]]
    xv, xi = _ref(RG.sdc_gather_topk_xla, q, codes, inv, ids, probes, None, n_levels=2, k=2)
    assert np.array_equal(pi, xi)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_chunking_does_not_change_results(masked):
    q, lc, inv, ids, probes, mask, _ = _inputs("ties_across_lists", 4, True)
    if masked:
        mask = np.random.default_rng(0).integers(0, 2, (Q, NPROBE, L)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, lc, inv, ids, probes)]
    m = None if mask is None else torch.from_numpy(mask)
    whole = PG.sdc_gather_topk_torch(*args, n_levels=4, k=17, packed=True, cand_mask=m)
    for chunk in (1, 7, 64):
        part = PG.sdc_gather_topk_torch(*args, n_levels=4, k=17, packed=True, cand_mask=m,
                                        chunk=chunk)
        assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])


def test_broadcast_mask_equals_a_dense_one():
    q, lc, inv, ids, probes, _, _ = _inputs("padded_out_of_range", 4, False)
    live = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (Q, NPROBE, 1)))
    args = [torch.from_numpy(a) for a in (q, lc, inv, ids, probes)]
    view = live.to(torch.float32).expand(-1, -1, L)
    a = PG.sdc_gather_topk(*args, n_levels=4, k=10, cand_mask=view)
    b = PG.sdc_gather_topk(*args, n_levels=4, k=10, cand_mask=view.contiguous())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("nlist,qc", [(6, 3), (6, 64), (1, 2), (50, 4)])
def test_gather_plan_covers_every_pair_once(nlist, qc):
    probes = torch.from_numpy(np.random.default_rng(nlist).integers(-2, nlist + 2, (7, 5)))
    order, pair_off, unit_off, max_units = PG.gather_plan(probes, nlist, qc)
    assert sorted(order.tolist()) == list(range(35))
    clamped = probes.reshape(-1).clamp(0, nlist - 1)
    for c in range(nlist):
        pairs = order[pair_off[c]:pair_off[c + 1]].tolist()
        assert pairs == sorted(pairs)
        assert all(int(clamped[p]) == c for p in pairs)
        assert unit_off[c + 1] - unit_off[c] == -(-len(pairs) // qc)
    assert int(unit_off[-1]) <= max_units


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_backend_dispatch_on_cpu(backend):
    q, lc, inv, ids, probes, mask, k = _inputs("partial_mask", 4, False)
    args = [torch.from_numpy(a) for a in (q, lc, inv, ids, probes)]
    m = torch.from_numpy(mask)
    want = PG.sdc_gather_topk_torch(*args, n_levels=4, k=k, cand_mask=m)
    before = PG.sdc_gather_topk.launches
    got = PO.sdc_gather_backend(*args, n_levels=4, k=k, backend=backend, cand_mask=m)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert PG.sdc_gather_topk.launches == before  # the CPU path launches no kernel
    with pytest.raises(ValueError):
        PO.sdc_gather_backend(*args, n_levels=4, k=k, backend="cuda")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, lc, inv, ids, probes, _, _ = _inputs("padded_out_of_range", 4, False)
    q, lc, inv, ids, probes = (torch.from_numpy(a) for a in (q, lc, inv, ids, probes))
    kw = dict(n_levels=4, k=5)
    for k in (0, PS.K_MAX + 1):
        with pytest.raises(ValueError):
            PG.sdc_gather_topk(q, lc, inv, ids, probes, n_levels=4, k=k)
    bad = [
        (q.to(torch.int32), lc, inv, ids, probes, {}),
        (q, lc, inv, ids, probes, {"packed": True}),  # int8 lists, packed flag
        (q, lc[..., :32], inv, ids, probes, {}),
        (q, lc, inv.double(), ids, probes, {}),
        (q, lc, inv, ids.long(), probes, {}),
        (q, lc, inv[:, :5], ids, probes, {}),
        (q, lc, inv, ids, probes[:2], {}),
        (q, lc, inv, ids, probes.float(), {}),
        (q, lc, inv, ids, probes, {"cand_mask": torch.ones(Q, NPROBE, L + 1)}),
    ]
    for *args, extra in bad:
        with pytest.raises(ValueError):
            PG.sdc_gather_topk(*args, **kw, **extra)


def test_largest_k_is_served():
    q, lc, inv, ids, probes, _, _ = _inputs("padded_out_of_range", 4, False)
    v, i = _port(q, lc, inv, ids, probes, None, n_levels=4, k=PS.K_MAX)
    assert v.shape == (Q, PS.K_MAX)
    assert (i[:, NPROBE * L:] == -1).all()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_lists(dev, gen, nlist, L_, D_, n_levels, Q_, nprobe):
    codes = torch.randint(0, 2**n_levels, (nlist, L_, D_), generator=gen, device=dev)
    codes = codes.to(torch.int8)
    codes[1::2] = codes[0::2][: nlist // 2]  # equal scores across lists
    inv = doc_inv_norms(codes.reshape(-1, D_), n_levels).reshape(nlist, L_)
    ids = torch.randperm(nlist * L_, generator=gen, device=dev).to(torch.int32)
    ids = ids.reshape(nlist, L_)
    inv[:, -L_ // 7:] = 0
    ids[:, -L_ // 7:] = -1
    q = torch.randint(0, 2**n_levels, (Q_, D_), generator=gen, device=dev).to(torch.int8)
    probes = torch.randint(-2, nlist + 2, (Q_, nprobe), generator=gen, device=dev)
    return q, codes, inv, ids, probes.to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["int8", "packed", "masked"])
@pytest.mark.parametrize("n_levels", [1, 4])
@pytest.mark.parametrize("nlist,L_,D_,Q_,nprobe,k", [(16, 3001, 128, 37, 8, 10),
                                                      (8, 17, 64, 5, 8, 100),
                                                      (4, 20_000, 32, 64, 4, 1024)])
def test_kernel_matches_plain_on_card(variant, n_levels, nlist, L_, D_, Q_, nprobe, k):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(nlist * L_ + n_levels)
    q, codes, inv, ids, probes = _card_lists(dev, gen, nlist, L_, D_, n_levels, Q_, nprobe)
    packed = variant == "packed"
    lc = pack_codes_nibbles(codes) if packed else codes
    mask = None
    if variant == "masked":
        mask = (torch.rand((Q_, nprobe, L_), generator=gen, device=dev) > 0.5).float()
    before = PG.sdc_gather_topk.launches
    v, i = PG.sdc_gather_topk(q, lc, inv, ids, probes, n_levels=n_levels, k=k, packed=packed,
                              cand_mask=mask)
    torch.cuda.synchronize()
    assert PG.sdc_gather_topk.launches == before + 1
    pv, pi = PG.sdc_gather_topk_torch(q, lc, inv, ids, probes, n_levels=n_levels, k=k,
                                      packed=packed, cand_mask=mask)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("Q_,N,D_,n_levels", [(37, 100_003, 128, 4), (130, 5_001, 64, 2),
                                               (3, 7, 32, 1)])
def test_scores_kernel_matches_plain_on_card(packed, Q_, N, D_, n_levels):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(Q_ * N)
    q = torch.randint(0, 2**n_levels, (Q_, D_), generator=gen, device=dev).to(torch.int8)
    d = torch.randint(0, 2**n_levels, (N, D_), generator=gen, device=dev).to(torch.int8)
    inv = doc_inv_norms(d, n_levels)
    inv[::5] = 0
    dd = pack_codes_nibbles(d) if packed else d
    before = PS.sdc_scores.launches
    s = PS.sdc_scores(q, dd, inv, n_levels=n_levels, packed=packed)
    torch.cuda.synchronize()
    assert PS.sdc_scores.launches == before + 1
    assert torch.equal(s, PS.sdc_scores_torch(q, dd, inv, n_levels=n_levels, packed=packed))
