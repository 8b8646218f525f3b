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
list holds the lower id (the order is by slot, not by id). The unfused
route the card takes for k > ``K_MAX`` or a code dim above 256
(``unfused_gather_topk``: the score matrix of every list slot, then
``select_probed_topk``) runs here on the plain score matrix and must give
the same bits as the plain version and the reference, with masks, ids of
-1 inside the lists and ties across lists. The CUDA kernels are held
against the plain version by the ``gpu`` tests (on the card only) and by
``chip_smoke.py``.
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
    with pytest.raises(ValueError):
        PG.sdc_gather_topk(q, lc, inv, ids, probes, n_levels=4, k=0)
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


@pytest.mark.parametrize("D_", [8, 16, 264, 300])
@pytest.mark.parametrize("packed", [False, True])
def test_gather_matches_reference_past_k_max_off_kernel_dims(D_, packed):
    # k = 5000 > K_MAX on CPU tensors, at code dims the card pads to 32 and
    # above the fused kernel's widest
    rng = np.random.default_rng(D_ + packed)
    nlist, L_, nprobe, k = 4, 2000, 3, 5000
    codes = rng.integers(0, 4, (nlist, L_, D_)).astype(np.int8)
    inv = np.array(RR.doc_inv_norms(jnp.asarray(codes.reshape(-1, D_)), 2)).reshape(nlist, L_)
    ids = rng.permutation(nlist * L_).astype(np.int32).reshape(nlist, L_)
    inv[:, -7:] = 0.0
    ids[:, -7:] = -1
    q = rng.integers(0, 4, (2, D_)).astype(np.int8)
    probes = np.array([[0, 2, 3], [3, 1, 1]], np.int32)
    lc = np.array(RB.pack_codes_nibbles(jnp.asarray(codes))) if packed else codes
    kw = dict(n_levels=2, k=k, packed=packed)
    pv, pi = _port(q, lc, inv, ids, probes, None, **kw)
    xv, xi = _ref(RG.sdc_gather_topk_xla, q, lc, inv, ids, probes, None, **kw)
    assert pv.shape == (2, k)
    assert np.array_equal(pv.view(np.uint32), xv.view(np.uint32))
    assert np.array_equal(pi, xi)
    t = (torch.from_numpy(a) for a in (q, lc, inv, ids, probes))
    uv, ui = PG.unfused_gather_topk(*t, **kw)
    assert np.array_equal(uv.numpy(), pv) and np.array_equal(ui.numpy(), pi)


def _unfused_inputs(seed, packed, D_=64):
    """Lists for the unfused route past K_MAX: every list a copy of list 0
    (ties across lists; later lists hold lower ids), padding, ids of -1
    inside the lists, probes out of range and repeated."""
    rng = np.random.default_rng(seed)
    nlist, L_, nprobe = 6, 1500, 4
    codes = np.repeat(rng.integers(0, 4, (1, L_, D_)).astype(np.int8), nlist, axis=0)
    ids = ((nlist - 1 - np.arange(nlist))[:, None] * L_ + np.arange(L_)).astype(np.int32)
    inv = np.array(RR.doc_inv_norms(jnp.asarray(codes.reshape(-1, D_)), 2)).reshape(nlist, L_)
    inv[:, -9:] = 0.0
    ids[:, -9:] = -1
    ids[rng.random((nlist, L_)) < 0.1] = -1
    q = rng.integers(0, 4, (3, D_)).astype(np.int8)
    probes = np.array([[0, 5, 2, 2], [-1, 9, 3, 1], [4, 0, 1, 3]], np.int32)
    lc = np.array(RB.pack_codes_nibbles(jnp.asarray(codes))) if packed else codes
    return q, lc, inv, ids, probes


@pytest.mark.parametrize("k", [PS.K_MAX + 1, 5000])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_unfused_route_matches_plain_and_reference_past_k_max(k, masked, packed):
    q, lc, inv, ids, probes = _unfused_inputs(k + 2 * masked + packed, packed)
    mask = None
    if masked:
        mask = (np.random.default_rng(k).random((3, 4, 1500)) > 0.3).astype(np.float32)
    kw = dict(n_levels=2, k=k, packed=packed)
    t = [torch.from_numpy(a) for a in (q, lc, inv, ids, probes)]
    m = None if mask is None else torch.from_numpy(mask)
    before = PS.sdc_scores.launches
    uv, ui = PG.unfused_gather_topk(*t, cand_mask=m, **kw)
    assert PS.sdc_scores.launches == before  # the CPU path launches no kernel
    pv, pi = PG.sdc_gather_topk_torch(*t, cand_mask=m, **kw)
    assert torch.equal(uv, pv) and torch.equal(ui, pi)
    xv, xi = _ref(RG.sdc_gather_topk_xla, q, lc, inv, ids, probes, mask, **kw)
    assert np.array_equal(uv.numpy().view(np.uint32), xv.view(np.uint32))
    assert np.array_equal(ui.numpy(), xi)
    live = uv > SDC_NEG_INF / 2
    assert (ui[~live] == -1).all() and not (ui[live] == -1).any()
    # the selection alone, on the plain score matrix of every list slot
    scores = PS.sdc_scores_torch(t[0], t[1].reshape(6 * 1500, -1), t[2].reshape(-1),
                                 n_levels=2, packed=packed)
    sv, si = PG.select_probed_topk(scores, t[4], t[2], t[3], k=k, cand_mask=m)
    assert torch.equal(sv, pv) and torch.equal(si, pi)


def test_unfused_query_chunks_do_not_change_results(monkeypatch):
    q, lc, inv, ids, probes = _unfused_inputs(11, True)
    mask = torch.from_numpy((np.random.default_rng(11).random((3, 4, 1500)) > 0.5)
                            .astype(np.float32))
    t = [torch.from_numpy(a) for a in (q, lc, inv, ids, probes)]
    kw = dict(n_levels=2, k=PS.K_MAX + 1, packed=True, cand_mask=mask)
    whole = PG.unfused_gather_topk(*t, **kw)
    monkeypatch.setattr(PG, "query_chunk", lambda device, Q, per_query: 2)
    part = PG.unfused_gather_topk(*t, **kw)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])


def test_select_probed_topk_ties_go_to_the_earlier_slot():
    # one query, two probed lists of one document each, equal scores: the
    # earlier probe column wins though the later list holds the lower id
    scores = torch.tensor([[2.0, 2.0, 5.0]])  # list c's slot pos at column c * L + pos
    ids = torch.tensor([[7], [2], [4]], dtype=torch.int32)
    inv = torch.ones((3, 1))
    v, i = PG.select_probed_topk(scores, torch.tensor([[0, 1]]), inv, ids, k=3)
    assert torch.equal(v, torch.tensor([[2.0, 2.0, SDC_NEG_INF]])) and i.tolist() == [[7, 2, -1]]
    v, i = PG.select_probed_topk(scores, torch.tensor([[1, 0]]), inv, ids, k=2,
                                 cand_mask=torch.tensor([[[1.0], [0.0]]]))
    assert torch.equal(v, torch.tensor([[2.0, SDC_NEG_INF]])) and i.tolist() == [[2, -1]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_lists(dev, gen, nlist, L_, D_, n_levels, Q_, nprobe, every=False, holes=False):
    codes = torch.randint(0, 2**n_levels, (nlist, L_, D_), generator=gen, device=dev)
    codes = codes.to(torch.int8)
    codes[1::2] = codes[0::2][: nlist // 2]  # equal scores across lists
    inv = doc_inv_norms(codes.reshape(-1, D_), n_levels).reshape(nlist, L_)
    ids = torch.randperm(nlist * L_, generator=gen, device=dev).to(torch.int32)
    ids = ids.reshape(nlist, L_)
    inv[:, -L_ // 7:] = 0
    ids[:, -L_ // 7:] = -1
    if holes:  # -1 ids inside the lists (inv kept), and a run of dead rounds
        ids[torch.rand((nlist, L_), generator=gen, device=dev) < 0.1] = -1
        ids[:, L_ // 8:L_ // 8 + 600] = -1
    q = torch.randint(0, 2**n_levels, (Q_, D_), generator=gen, device=dev).to(torch.int8)
    if every:  # each query probes nprobe distinct lists: nprobe = nlist gives Q_ pairs a list
        probes = torch.stack([torch.randperm(nlist, generator=gen, device=dev)[:nprobe]
                              for _ in range(Q_)])
    else:
        probes = torch.randint(-2, nlist + 2, (Q_, nprobe), generator=gen, device=dev)
    return q, codes, inv, ids, probes.to(torch.int32)


# nlist, L, D, Q, nprobe, k, every, holes: lengths that are no multiple of 16
# or of the 256-row tile, 1 / 7 / 9 / 65 pairs on every list (65: several units
# on one list), ids of -1 inside the lists, D = 256, k = K_MAX (one pair
# per block), code dims the wrapper pads, and the unfused route: k = 4097
# and 5000, and code dims 264, 300 and 512.
CARD_CASES = [(16, 3001, 128, 37, 8, 10, False, False),
              (8, 17, 64, 5, 8, 100, False, False),
              (4, 20_000, 32, 64, 4, 1024, False, False),
              (6, 1000, 128, 1, 6, 10, True, False),
              (6, 999, 128, 7, 6, 10, True, True),
              (6, 2049, 64, 9, 6, 33, True, True),
              (6, 3001, 128, 65, 6, 10, True, True),
              (8, 5003, 256, 33, 4, 10, False, True),
              (4, 3000, 128, 5, 2, PS.K_MAX, False, True),
              (4, 3000, 256, 5, 2, PS.K_MAX, True, False),
              (6, 999, 16, 7, 6, 10, True, True),  # D = 16, padded to 32
              (8, 2001, 48, 9, 4, 33, False, False),  # D = 48, padded to 64
              (4, 3000, 128, 5, 2, PS.K_MAX + 1, False, True),
              (6, 2000, 64, 9, 4, 5000, True, True),
              (6, 999, 300, 7, 6, 10, True, True),
              (8, 2001, 264, 9, 4, 33, False, False),
              (4, 1500, 512, 5, 2, 10, False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["int8", "packed", "masked"])
@pytest.mark.parametrize("n_levels", [1, 4])
@pytest.mark.parametrize("nlist,L_,D_,Q_,nprobe,k,every,holes", CARD_CASES)
def test_kernel_matches_plain_on_card(variant, n_levels, nlist, L_, D_, Q_, nprobe, k, every,
                                      holes):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(nlist * L_ + n_levels)
    q, codes, inv, ids, probes = _card_lists(dev, gen, nlist, L_, D_, n_levels, Q_, nprobe,
                                             every, holes)
    packed = variant == "packed"
    lc = pack_codes_nibbles(codes) if packed else codes
    mask = None
    if variant == "masked":
        mask = (torch.rand((Q_, nprobe, L_), generator=gen, device=dev) > 0.5).float()
    fused = k <= PS.K_MAX and D_ <= 256  # else: sdc_scores and the selection
    before = (PG.sdc_gather_topk.launches, PS.sdc_scores.launches)
    v, i = PG.sdc_gather_topk(q, lc, inv, ids, probes, n_levels=n_levels, k=k, packed=packed,
                              cand_mask=mask)
    torch.cuda.synchronize()
    assert (PG.sdc_gather_topk.launches, PS.sdc_scores.launches) == \
        (before[0] + fused, before[1] + (not fused))
    pv, pi = PG.sdc_gather_topk_torch(q, lc, inv, ids, probes, n_levels=n_levels, k=k,
                                      packed=packed, cand_mask=mask)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("Q_,N,D_,n_levels", [(37, 100_003, 128, 4), (130, 5_001, 64, 2),
                                               (3, 7, 32, 1), (9, 3_001, 16, 4),
                                               (64, 30_011, 128, 1), (17, 20_011, 264, 2),
                                               (65, 10_007, 300, 4), (5, 4_099, 512, 1)])
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
    assert s.shape == (Q_, N) and s.stride(0) % PS.SCORES_ROW_STEP == 0
    assert torch.equal(s, PS.sdc_scores_torch(q, dd, inv, n_levels=n_levels, packed=packed))


@pytest.mark.gpu
def test_unfused_routes_chunk_queries_on_card(monkeypatch):
    dev = _card()
    q, lc, inv, ids, probes = _unfused_inputs(5, False)
    args = [torch.from_numpy(a).to(dev) for a in (q, lc, inv, ids, probes)]
    want = PG.sdc_gather_topk_torch(*args, n_levels=2, k=5000)
    flat = (args[0], args[1].reshape(-1, args[1].shape[-1]), args[2].reshape(-1))
    want_flat = PS.sdc_topk_torch(*flat, n_levels=2, k=5000)
    for mod in (PG, PS):  # a chunk of one query at a time
        monkeypatch.setattr(mod, "query_chunk", lambda device, Q, per_query: 1)
    before = PS.sdc_scores.launches
    got = PG.sdc_gather_topk(*args, n_levels=2, k=5000)
    got_flat = PS.sdc_topk(*flat, n_levels=2, k=5000)
    torch.cuda.synchronize()
    assert PS.sdc_scores.launches == before + 2 * q.shape[0]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got_flat[0], want_flat[0]) and torch.equal(got_flat[1], want_flat[1])


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_k_past_k_max_takes_the_unfused_route_on_card(masked):
    dev = _card()
    q, lc, inv, ids, probes = _unfused_inputs(7, False)
    mask = None
    if masked:
        mask = torch.from_numpy((np.random.default_rng(7).random((3, 4, 1500)) > 0.3)
                                .astype(np.float32)).to(dev)
    args = [torch.from_numpy(a).to(dev) for a in (q, lc, inv, ids, probes)]
    before = (PG.sdc_gather_topk.launches, PS.sdc_scores.launches)
    v, i = PG.sdc_gather_topk(*args, n_levels=2, k=PS.K_MAX + 1, cand_mask=mask)
    torch.cuda.synchronize()
    assert (PG.sdc_gather_topk.launches, PS.sdc_scores.launches) == (before[0], before[1] + 1)
    pv, pi = PG.sdc_gather_topk_torch(*args, n_levels=2, k=PS.K_MAX + 1, cand_mask=mask)
    assert torch.equal(v, pv) and torch.equal(i, pi)
