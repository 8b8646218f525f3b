"""The bi-granular slice of the PyTorch port (coarse scan + fine rerank)
against the JAX reference.

Small sizes on the CPU (n <= 256 documents, code dim 8, n_levels 4), the
same numpy inputs through both packages. The rerank, in its
device-resident layout (N lists of one row) and host-gathered at group
sizes 1, 3 and 8 (a ``np.memmap`` tier too), must be bit-identical to
the reference's ``sdc_rerank_xla`` and to a full-level flat scan
restricted to the survivors, scores and ids, and its scores and live ids
to the Pallas ``sdc_rerank`` in interpret mode (which returns the real
ids of masked slots). The port's ``doc_inv_norms`` may differ from the
reference's by one ulp, so where the bits of an index are compared the
reference's inverse norms are handed over (``reference_norms``), and the
IVF closures get the reference's k-means++ draws (``reference_draws``).
``BiGranularFlat``, both snapshot closures (rerank and effort included),
``split_effort``, the argument resolvers (their messages too),
``EffortKnob`` and the CLI's ``--coarse-levels``/``--k-coarse`` are held
against the reference. ``gpu`` cases hold the card against the plain
version.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_rerank import _restricted_scan  # noqa: E402

from repro.core.binarize_lib import SDC_NEG_INF, pack_codes_nibbles  # noqa: E402
from repro.index import _snapshot as RSN  # noqa: E402
from repro.index import flat as RF  # noqa: E402
from repro.index import ivf as RI  # noqa: E402
from repro.index import kmeans as RK  # noqa: E402
from repro.kernels.sdc import ref as RR  # noqa: E402
from repro.kernels.sdc import rerank as RRK  # noqa: E402
from repro.launch import proxy as RP  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.index import _snapshot as PSN  # noqa: E402
from repro_torch.index import flat as PF  # noqa: E402
from repro_torch.index import ivf as PI  # noqa: E402
from repro_torch.index import kmeans as PK  # noqa: E402
from repro_torch.kernels.sdc import gather as PG  # noqa: E402
from repro_torch.kernels.sdc import ref as PR  # noqa: E402
from repro_torch.kernels.sdc import rerank as PRK  # noqa: E402
from repro_torch.kernels.sdc.defaults import BlockPlan  # noqa: E402
from repro_torch.launch import proxy as PP  # noqa: E402
from repro_torch.launch import serve as PSV  # noqa: E402

LEVELS, D = 4, 8
NLIST, NPROBE, ITERS = 8, 4, 5


def _world(seed, n=96, q=3, d=D):
    rng = np.random.default_rng(seed)
    cd = rng.integers(0, 2**LEVELS, (n, d)).astype(np.int8)
    cq = rng.integers(0, 2**LEVELS, (q, d)).astype(np.int8)
    return cd, cq, np.array(RR.doc_inv_norms(jnp.asarray(cd), LEVELS))


def _candidates(seed, n, q, kp, n_invalid=0):
    """Distinct survivor ids per query, shuffled, with ``n_invalid`` -1 slots."""
    rng = np.random.default_rng(seed)
    cand = np.stack([rng.choice(n, size=kp, replace=False) for _ in range(q)]).astype(np.int32)
    for r in range(q):
        cand[r, rng.choice(kp, size=n_invalid, replace=False)] = -1
    return cand


def _restricted(cq, cd, inv, cand, k):
    """The restricted full-level flat scan of ``test_rerank``; a query with
    no live candidate gets (SDC_NEG_INF, -1) in every slot."""
    scores = np.full((cq.shape[0], k), SDC_NEG_INF, np.float32)
    ids = np.full((cq.shape[0], k), -1, np.int32)
    live = (cand >= 0).any(axis=1)
    if live.any():
        scores[live], ids[live] = _restricted_scan(jnp.asarray(cq[live]), jnp.asarray(cd),
                                                   jnp.asarray(inv), cand[live], k)
    return scores, ids


def _np(out):
    return tuple(np.asarray(x) for x in out)


def _same(want, got):
    ws, wi = _np(want)
    gs, gi = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in got)
    assert np.array_equal(gi, wi)
    assert np.array_equal(gs.view(np.uint32), ws.view(np.uint32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's index builds take the reference's inverse norms."""
    def doc_inv_norms(codes, n_levels):
        inv = RR.doc_inv_norms(jnp.asarray(codes.cpu().numpy()), n_levels)
        return torch.from_numpy(np.array(inv)).to(codes.device)

    monkeypatch.setattr(PR, "doc_inv_norms", doc_inv_norms)


@pytest.fixture
def reference_draws(monkeypatch):
    """The port's k-means starts from the reference's k-means++ picks for ``seed``."""
    def hand_over(seed):
        def kmeans_pp_init(key, x, k):
            init = RK.kmeans_pp_init(jax.random.PRNGKey(seed), jnp.asarray(x.cpu().numpy()), k)
            return torch.from_numpy(np.array(init)).to(x.device)

        monkeypatch.setattr(PK, "kmeans_pp_init", kmeans_pp_init)

    return hand_over


def test_sort_candidates_equals_reference():
    cand = _candidates(0, 500, 6, 40, n_invalid=7)
    got = PRK._sort_candidates(_t(cand))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(RRK._sort_candidates(jnp.asarray(cand))))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_invalid", [0, 3])
@pytest.mark.parametrize("kp", [3, 5, 16])
def test_rerank_bit_identical_to_reference(kp, n_invalid, packed):
    """k' below k (4), 3 invalid slots (all of them at k' = 3), int8 and packed."""
    seed = 10 * kp + n_invalid + packed
    cd, cq, inv = _world(seed)
    cand = _candidates(seed, cd.shape[0], cq.shape[0], kp, n_invalid)
    k = 4
    fine = np.array(pack_codes_nibbles(jnp.asarray(cd))) if packed else cd
    want = RRK.sdc_rerank_xla(jnp.asarray(cq), jnp.asarray(fine), jnp.asarray(inv),
                              jnp.asarray(cand), n_levels=LEVELS, k=k, packed=packed)
    _same(_restricted(cq, cd, inv, cand, k), want)
    for fn in (PRK.sdc_rerank, PRK.sdc_rerank_torch):
        _same(want, fn(_t(cq), _t(fine), _t(inv), _t(cand), n_levels=LEVELS, k=k,
                       packed=packed))
    _same(want, PRK.sdc_rerank_gathered(_t(cq), fine, inv, _t(cand), n_levels=LEVELS, k=k,
                                        packed=packed))
    # the Pallas kernel: the same scores, the same ids on live slots
    ps, pi = _np(RRK.sdc_rerank(jnp.asarray(cq), jnp.asarray(fine), jnp.asarray(inv),
                                jnp.asarray(cand), n_levels=LEVELS, k=k, interpret=True,
                                packed=packed))
    gs, gi = (x.numpy() for x in PRK.sdc_rerank(_t(cq), _t(fine), _t(inv), _t(cand),
                                                 n_levels=LEVELS, k=k, packed=packed))
    live = gs > SDC_NEG_INF / 2
    assert np.array_equal(gs.view(np.uint32), ps.view(np.uint32))
    assert np.array_equal(gi[live], pi[live]) and (gi[~live] == -1).all()
    if kp < k:
        assert (gi[:, kp:] == -1).all() and (gs[:, kp:] == SDC_NEG_INF).all()


@pytest.mark.parametrize("layout", ["device", "torch", "host 1", "host 3", "host 8"])
def test_ties_go_to_the_lower_id(layout):
    """Docs j and j + 48 hold the same codes, and every query's survivors
    hold both copies, the higher id first: the rerank's sort, not the
    coarse order, makes the lower id win each tie."""
    cd, cq, _ = _world(50, n=96, q=4)
    cd[48:] = cd[:48]
    inv = np.array(RR.doc_inv_norms(jnp.asarray(cd), LEVELS))
    rng = np.random.default_rng(51)
    cand = np.stack([np.concatenate([j + 48, j]) for j in
                     (rng.choice(48, size=6, replace=False) for _ in range(4))]).astype(np.int32)
    k = 5
    want = RRK.sdc_rerank_xla(jnp.asarray(cq), jnp.asarray(cd), jnp.asarray(inv),
                              jnp.asarray(cand), n_levels=LEVELS, k=k)
    _same(_restricted(cq, cd, inv, cand, k), want)
    assert (np.asarray(want[1]) < 48).sum() > (np.asarray(want[1]) >= 48).sum()
    args = (_t(cq), cd, inv, _t(cand))
    if layout == "device":
        got = PRK.sdc_rerank(_t(cq), _t(cd), _t(inv), _t(cand), n_levels=LEVELS, k=k)
    elif layout == "torch":
        got = PRK.sdc_rerank_torch(_t(cq), _t(cd), _t(inv), _t(cand), n_levels=LEVELS, k=k)
    else:
        got = PRK.sdc_rerank_gathered(*args, n_levels=LEVELS, k=k, group=int(layout[-1]))
    _same(want, got)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("group", [1, 3, 8])
def test_rerank_gathered_is_the_same_for_every_group(group, packed):
    cd, cq, inv = _world(40 + group, q=5)
    cand = _candidates(41 + group, cd.shape[0], cq.shape[0], 16, n_invalid=3)
    k = 5
    fine = np.array(pack_codes_nibbles(jnp.asarray(cd))) if packed else cd
    want = RRK.sdc_rerank_gathered(jnp.asarray(cq), fine, inv, cand, n_levels=LEVELS, k=k,
                                   packed=packed, group=group)
    _same(_restricted(cq, cd, inv, cand, k), want)
    for backend in ("auto", "torch"):
        _same(want, PRK.sdc_rerank_gathered(_t(cq), fine, inv, _t(cand), n_levels=LEVELS, k=k,
                                            packed=packed, group=group, backend=backend))
    plan = BlockPlan("rerank", 1, group)
    _same(want, PRK.sdc_rerank_backend(_t(cq), fine, inv, _t(cand), n_levels=LEVELS, k=k,
                                       packed=packed, block_plan=plan))


def test_memmap_cold_tier_and_fine_inv_norms(tmp_path):
    """A read-only memmap tier takes the host gather; ``fine_inv_norms``
    streams it in chunks of 17 to the bits of a single-shot
    ``doc_inv_norms``, within one ulp of the reference's."""
    cd, cq, inv = _world(3)
    path = tmp_path / "fine.codes"
    mm = np.memmap(path, dtype=np.int8, mode="w+", shape=cd.shape)
    mm[:] = cd
    mm.flush()
    cold = np.memmap(path, dtype=np.int8, mode="r", shape=cd.shape)
    streamed = PRK.fine_inv_norms(cold, LEVELS, chunk=17, device="cpu")
    single = PR.doc_inv_norms(_t(cd), LEVELS)
    assert isinstance(streamed, np.ndarray)
    assert np.array_equal(streamed.view(np.uint32), single.numpy().view(np.uint32))
    assert np.abs(streamed.view(np.int32) - inv.view(np.int32)).max() <= 1
    assert torch.equal(PRK.fine_inv_norms(_t(cd), LEVELS), single)  # a tensor passes through
    cand = _candidates(3, cd.shape[0], cq.shape[0], 9)
    k = 5
    want = RRK.sdc_rerank_backend(jnp.asarray(cq), cold, inv, cand, n_levels=LEVELS, k=k)
    _same(_restricted(cq, cd, inv, cand, k), want)
    _same(want, PRK.sdc_rerank_backend(_t(cq), cold, inv, _t(cand), n_levels=LEVELS, k=k))


def test_invalid_slots_never_leak_doc_zero():
    """Doc 0 is every query's best match but no survivor: the clamped
    probes of the empty slots read it, and only the mask keeps it out."""
    cd, cq, inv = _world(11)
    cd[0] = 2**LEVELS - 1
    cq[:] = 2**LEVELS - 1
    inv = PR.doc_inv_norms(_t(cd), LEVELS).numpy()
    cand = _candidates(11, cd.shape[0], cq.shape[0], 8, n_invalid=3)
    cand[cand == 0] = 1 if not (cand == 1).any() else -1
    assert not (cand == 0).any()
    for fn in (PRK.sdc_rerank, PRK.sdc_rerank_torch):
        _, ids = fn(_t(cq), _t(cd), _t(inv), _t(cand), n_levels=LEVELS, k=8)
        assert not (ids == 0).any() and (ids[:, 5:] == -1).all()
    _, ids = PRK.sdc_rerank_gathered(_t(cq), cd, inv, _t(cand), n_levels=LEVELS, k=8)
    assert not (ids == 0).any() and (ids[:, 5:] == -1).all()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("coarse_levels", [1, 2, 3])
def test_bigranular_flat_equals_reference(reference_norms, coarse_levels, packed):
    cd, cq, _ = _world(20 + coarse_levels, n=200, q=6)
    ref = RF.BiGranularFlat.build(jnp.asarray(cd), LEVELS, coarse_levels=coarse_levels,
                                  k_coarse=12, packed=packed, backend="xla")
    want = ref.search(jnp.asarray(cq), 5)
    for codes in (cd, _t(cd)):  # a host fine tier, a device one
        got = PF.BiGranularFlat.build(codes, LEVELS, coarse_levels=coarse_levels, k_coarse=12,
                                      packed=packed, device="cpu")
        assert isinstance(got.fine_codes, np.ndarray) == isinstance(codes, np.ndarray)
        assert got.coarse.packed == ref.coarse.packed
        assert (got.coarse_nbytes(), got.nbytes()) == (ref.coarse_nbytes(), ref.nbytes())
        _same(want, got.search(_t(cq), 5))
        _same(ref.search(jnp.asarray(cq), 5, k_coarse=7), got.search(_t(cq), 5, k_coarse=7))


@pytest.mark.parametrize("packed", [False, True])
def test_bigranular_at_k_coarse_n_is_the_flat_scan(packed):
    cd, cq, _ = _world(5, n=128, q=5)
    bigr = PF.BiGranularFlat.build(cd, LEVELS, coarse_levels=2, k_coarse=cd.shape[0],
                                   packed=packed, device="cpu")
    flat = PF.FlatSDC.build(cd, LEVELS, device="cpu")
    _same(_np(flat.search(_t(cq), 10)), bigr.search(_t(cq), 10))
    _same(_np(flat.search(_t(cq), 10)), bigr.search(_t(cq), 10, k_coarse=10**6))


def _knob(level):
    knob = PP.EffortKnob(n_levels=10)
    for _ in range(level):
        knob.degrade()
    return knob


@pytest.mark.parametrize("mode", ["plain", "rerank", "rerank level 0", "rerank level 9"])
def test_flat_snapshot_closure_equals_reference(reference_norms, mode):
    """Level 0 equals no knob; level 9 is ``split_effort``'s floor of k'
    (32 -> 16 -> 8, 8 // 5 stops the halving)."""
    cd, cq, _ = _world(23, n=128, q=4)
    snap = types.SimpleNamespace(codes=cd, n_levels=LEVELS)
    rerank = None if mode == "plain" else {"coarse_levels": 2, "k_coarse": 32}
    knob = _knob(int(mode[-1])) if "level" in mode else None
    ref = RF.flat_search_from_snapshot(snap, k=5, rerank=rerank, effort=knob, backend="xla")
    got = PF.flat_search_from_snapshot(snap, k=5, rerank=rerank, effort=knob, device="cpu")
    assert getattr(got, "reranked", False) == getattr(ref, "reranked", False)
    assert getattr(got, "effort", None) is knob
    _same(ref(jnp.asarray(cq)), got(_t(cq)))
    if knob is not None:
        plain = PF.flat_search_from_snapshot(snap, k=5, rerank=rerank, device="cpu")
        bigr = PF.BiGranularFlat.build(cd, LEVELS, coarse_levels=2, k_coarse=32,
                                       device="cpu")
        floor, _ = PSN.split_effort(knob.level, k=5, k_coarse=32)
        want = plain(_t(cq)) if knob.level == 0 else bigr.search(_t(cq), 5, k_coarse=floor)
        _same(_np(want), got(_t(cq)))
        assert knob.level == 0 or floor == 8


IVF_CASES = [
    (None, None, None), (None, None, 0), (None, None, 2), (None, 35, None), (None, 35, 1),
    ((2, 24), None, None), ((2, 24), None, 0), ((2, 24), None, 9), ((2, 24), 35, None),
    ((3, 40), 35, 4),
]


@pytest.mark.parametrize("rerank, budget, level", IVF_CASES)
def test_ivf_snapshot_closure_equals_reference(reference_norms, reference_draws, rerank,
                                               budget, level):
    """nprobe 4 or the masked budget 35 over nlist 8, with and without
    rerank and an effort knob (level 9: the floor of k', the rest on
    nprobe); the k-means starts from the reference's picks."""
    cd, cq, _ = _world(30, n=256, q=6)
    cd = np.clip(cd[np.arange(256) % 8] + np.random.default_rng(1).integers(-1, 2, cd.shape),
                 0, 15).astype(np.int8)  # clustered, so the lists differ in occupancy
    snap = types.SimpleNamespace(codes=cd, n_levels=LEVELS)
    rr = None if rerank is None else {"coarse_levels": rerank[0], "k_coarse": rerank[1]}
    knob = None if level is None else _knob(level)
    kw = dict(k=5, nlist=NLIST, nprobe=NPROBE, seed=3, kmeans_iters=ITERS, coarse_sdc=True,
              rerank=rr, probe_budget=budget, effort=knob)
    reference_draws(3)
    ref = RI.ivf_search_from_snapshot(snap, backend="xla", **kw)
    got = PI.ivf_search_from_snapshot(snap, device="cpu", **kw)
    assert getattr(got, "reranked", False) == getattr(ref, "reranked", False)
    assert getattr(got, "effort", None) is knob
    _same(ref(jnp.asarray(cq)), got(_t(cq)))
    if level == 0:
        _same(_np(PI.ivf_search_from_snapshot(snap, device="cpu", **{**kw, "effort": None})(
            _t(cq))), got(_t(cq)))


def test_split_effort_and_resolvers_equal_reference():
    for level in range(-1, 10):
        for k in (1, 5, 10):
            for kc in (1, 10, 16, 160, 1000):
                want = RSN.split_effort(level, k=k, k_coarse=kc)
                assert PSN.split_effort(level, k=k, k_coarse=kc) == want

    def same_outcome(fn_name, *args):
        try:
            want = ("ok", getattr(RSN, fn_name)(*args))
        except (TypeError, ValueError) as e:
            want = (type(e), str(e))
        try:
            got = ("ok", getattr(PSN, fn_name)(*args))
        except (TypeError, ValueError) as e:
            got = (type(e), str(e))
        assert got == want, (fn_name, args)

    for rerank in (None, {"coarse_levels": 2, "k_coarse": 64}, {"coarse_levels": 2},
                   {"coarse_levels": 2, "k_coarse": 64, "typo": 1},
                   {"coarse_levels": 4, "k_coarse": 64}, {"coarse_levels": 0, "k_coarse": 64},
                   {"coarse_levels": 2, "k_coarse": 0}):
        same_outcome("resolve_rerank_args", rerank, 4)
    codes = np.zeros((4, 8), np.int8)
    for snap, n_levels in ((types.SimpleNamespace(codes=codes, n_levels=4), None),
                           (types.SimpleNamespace(codes=codes, n_levels=4), 4),
                           (types.SimpleNamespace(codes=codes, n_levels=4), 3),
                           (types.SimpleNamespace(codes=codes, n_levels=None), None),
                           (codes, None), (codes, 2)):
        same_outcome("resolve_snapshot_args", snap, n_levels)


def test_effort_knob_equals_reference():
    with pytest.raises(ValueError, match="n_levels >= 1"):
        PP.EffortKnob(0)
    ref, got = RP.EffortKnob(3), PP.EffortKnob(3)
    for op in ("degrade", "degrade", "degrade", "restore", "degrade", "reset", "restore",
               "degrade", "restore", "restore"):
        assert getattr(got, op)() == getattr(ref, op)()
        assert (got.level, got.degrade_count, got.restore_count, got.max_level) == (
            ref.level, ref.degrade_count, ref.restore_count, ref.max_level)


CLI = ["--device", "cpu", "--docs", "600", "--queries", "32", "--dim", "32", "--code-dim",
       "16", "--batch", "16", "--rounds", "1", "--steps", "0"]


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_cli_serves_bigranular_on_the_cpu(capsys, tmp_path, index):
    PSV.main(CLI + ["--ckpt-cache", str(tmp_path), "--index", index, "--coarse-levels", "2",
                    "--k-coarse", "64"])
    out = capsys.readouterr().out
    assert "[index] bi-granular tiers (serialized): coarse" in out
    assert "(hot, 2/4 levels)" in out and "rerank k'=64" in out
    assert "[serve] recall@10" in out and "[serve] routed" in out


@pytest.mark.parametrize("extra, message", [
    (["--coarse-levels", "2"], "--coarse-levels and --k-coarse must be set together"),
    (["--k-coarse", "64"], "--coarse-levels and --k-coarse must be set together"),
    (["--coarse-levels", "4", "--k-coarse", "64"],
     "--coarse-levels must be in [1, 3] (got 4 of --levels 4)"),
])
def test_cli_refuses_half_or_full_depth_bigranular(capsys, extra, message):
    with pytest.raises(SystemExit) as e:
        PSV.main(CLI + extra)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


# ---------------------------------------------------------------------------
# On the card: every route equal to the plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_world(dev, n=5003, q=7, d=128, kp=40):
    g = torch.Generator(device=dev).manual_seed(n + kp)
    cd = torch.randint(0, 2**LEVELS, (n, d), generator=g, device=dev).to(torch.int8)
    cq = torch.randint(0, 2**LEVELS, (q, d), generator=g, device=dev).to(torch.int8)
    cand = torch.stack([torch.randperm(n, generator=g, device=dev)[:kp] for _ in range(q)])
    cand[:, ::7] = -1
    return cd, cq, cand.to(torch.int32), PR.doc_inv_norms(cd, LEVELS)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("kp", [3, 40, 300])
def test_rerank_on_card_equals_plain(card, kp, packed):
    cd, cq, cand, inv = _card_world(card, kp=kp)
    fine = PB.pack_codes_nibbles(cd) if packed else cd
    want = PRK.sdc_rerank_torch(cq, fine, inv, cand, n_levels=LEVELS, k=10, packed=packed)
    before = PG.sdc_gather_topk.launches
    got = PRK.sdc_rerank(cq, fine, inv, cand, n_levels=LEVELS, k=10, packed=packed)
    assert PG.sdc_gather_topk.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    host, host_inv = fine.cpu().numpy(), inv.cpu().numpy()
    for group in (1, 3, 8):
        got = PRK.sdc_rerank_gathered(cq, host, host_inv, cand, n_levels=LEVELS, k=10,
                                      packed=packed, group=group)
        assert got[0].device.type == "cuda"
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["flat", "ivf"])
def test_bigranular_closures_on_card_equal_plain(card, family):
    cd, cq, _, _ = _card_world(card, n=20_011, q=33)
    rr = {"coarse_levels": 2, "k_coarse": 64}
    if family == "flat":
        build = PF.flat_search_from_snapshot
        kw = dict(k=10, packed=True, rerank=rr)
    else:
        build = PI.ivf_search_from_snapshot
        kw = dict(k=10, nlist=16, nprobe=8, seed=1, rerank=rr, packed=True)
    plain = build(cd, LEVELS, backend="torch", **kw)(cq)
    for codes in (cd, cd.cpu().numpy()):  # a device fine tier, a host one
        got = build(codes, LEVELS, **kw)(cq)
        assert got[0].device.type == "cuda"
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
