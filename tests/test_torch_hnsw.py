"""The HNSW slice of the PyTorch port (``repro_torch/index/hnsw_lite.py``)
against the JAX reference (``repro/index/hnsw_lite.py``).

Small sizes on the CPU, the same numpy inputs through both packages. The
graph build (neighbours, entry, packed bytes), ``_entry_points``, the
numpy ``search_hnsw``, the ``prepare_batched`` tables and both
``nbytes``, the batched-frontier search (scores, ids and stats, int8 and
packed, on the reference's "xla" backend as ``tests/test_hnsw_parity.py``
runs it), the snapshot closures (effort levels, bi-granular rerank) and
``build_hnsw_sharded`` must be bit-identical to the reference. The port's
``doc_inv_norms`` may differ from the reference's by one ulp, so every
build takes the reference's inverse norms. ``gpu`` cases hold the card's
kernels against the plain version.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.index import hnsw_lite as RH  # noqa: E402
from repro.kernels.sdc import ref as RR  # noqa: E402
from repro_torch.index import hnsw_lite as PH  # noqa: E402
from repro_torch.kernels.sdc import gather as PG  # noqa: E402
from repro_torch.kernels.sdc import ref as PR  # noqa: E402
from repro_torch.kernels.sdc import sdc as PS  # noqa: E402
from repro_torch.launch import proxy as PP  # noqa: E402
from repro_torch.launch import serve as PSV  # noqa: E402

LEVELS = 4

# (n, q, dim, M, n_levels): the reference's parity corpus, its small one,
# one whose rows keep -1 neighbours (n < M + 1 leaves slots empty), and one
# at n_levels 1, where most scores tie
WORLDS = {
    "n400": (400, 8, 32, 8, 4),
    "n64": (64, 4, 32, 4, 4),
    "empty slots": (12, 5, 16, 16, 4),
    "ties": (300, 6, 16, 8, 1),
}


def _world(name, seed=3):
    """``tests/test_hnsw_parity.py::_random_graph``'s codes, and the reference's norms."""
    n, q, dim, _, levels = WORLDS[name]
    key = jax.random.PRNGKey(seed)
    cd = np.asarray(jax.random.randint(key, (n, dim), 0, 2**levels), np.int8)
    cq = np.asarray(jax.random.randint(jax.random.fold_in(key, 1), (q, dim), 0, 2**levels),
                    np.int8)
    return cd, cq, np.asarray(RR.doc_inv_norms(jnp.asarray(cd), levels))


def _graphs(name, packed=False, ef_construction=32):
    cd, cq, inv = _world(name)
    _, _, _, M, levels = WORLDS[name]
    kw = dict(n_levels=levels, M=M, ef_construction=ef_construction, seed=0, packed=packed)
    return RH.build_hnsw(cd, inv, **kw), PH.build_hnsw(cd, inv, **kw), cq


def _same(want, got):
    ws, wi = (np.asarray(x) for x in want[:2])
    gs, gi = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in got[:2])
    assert np.array_equal(gi, wi)
    assert np.array_equal(gs.view(np.uint32), ws.view(np.uint32))


def _same_stats(want, got):
    for key in ("hops", "scored"):
        assert np.array_equal(np.asarray(want[key]), got[key].cpu().numpy()), key


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def reference_norms(monkeypatch):
    """The port's builds take the reference's inverse norms."""
    def doc_inv_norms(codes, n_levels):
        inv = RR.doc_inv_norms(jnp.asarray(codes.cpu().numpy()), n_levels)
        return torch.from_numpy(np.array(inv)).to(codes.device)

    monkeypatch.setattr(PR, "doc_inv_norms", doc_inv_norms)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", list(WORLDS))
def test_graph_bit_identical_to_reference(name, packed):
    ref, got, _ = _graphs(name, packed=packed)
    assert got.neighbors.dtype == ref.neighbors.dtype
    assert np.array_equal(got.neighbors, ref.neighbors)
    assert got.entry == ref.entry and got.packed == ref.packed
    assert got.codes.dtype == ref.codes.dtype and np.array_equal(got.codes, ref.codes)
    assert np.array_equal(got.unpacked_codes(), ref.unpacked_codes())
    assert got.code_dim == ref.code_dim
    assert got.nbytes() == ref.nbytes()
    if name == "empty slots":
        assert (got.neighbors < 0).any()


def test_graph_bit_identical_across_build_blocks(monkeypatch):
    """The build scores a block of steps at once; a block of one step and
    blocks that cut the steps anywhere give the same graph."""
    cd, _, inv = _world("n400")
    want = RH.build_hnsw(cd, inv, n_levels=LEVELS, M=8, ef_construction=16, seed=5)
    for elems in (1, 400 * 7, 1 << 23):
        monkeypatch.setattr(PH, "_BUILD_BLOCK_ELEMS", elems)
        got = PH.build_hnsw(cd, inv, n_levels=LEVELS, M=8, ef_construction=16, seed=5)
        assert np.array_equal(got.neighbors, want.neighbors) and got.entry == want.entry


def test_packed_build_needs_four_levels():
    cd, _, inv = _world("n64")
    for mod in (RH, PH):
        with pytest.raises(ValueError, match="packed HNSW codes need n_levels <= 4, got 5"):
            mod.build_hnsw(cd, inv, n_levels=5, M=4, packed=True)


def test_entry_points_equal_reference():
    for n, entry, n_entries, seed in [(400, 7, 8, 0), (400, 7, 1, 3), (5, 2, 8, 1),
                                      (64, 0, 0, 2), (1000, 999, 16, 9)]:
        want = RH._entry_points(n, entry, n_entries, seed)
        got = PH._entry_points(n, entry, n_entries, seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["n400", "n64", "empty slots"])
@pytest.mark.parametrize("packed", [False, True])
def test_numpy_search_equals_reference(name, packed):
    ref, got, cq = _graphs(name, packed=packed)
    for q in cq:
        for k, ef in ((5, 16), (10, 64)):
            _same(RH.search_hnsw(ref, q, k=k, ef=ef), PH.search_hnsw(got, q, k=k, ef=ef))


@pytest.mark.parametrize("override", [None, False, True])
@pytest.mark.parametrize("name", ["n400", "empty slots"])
def test_prepare_batched_equals_reference(name, override):
    ref, got, _ = _graphs(name)
    want = RH.prepare_batched(ref, packed=override)
    tables = PH.prepare_batched(got, packed=override, device="cpu")
    for f in ("codes", "inv_norm", "nbr_codes", "nbr_inv", "nbr_ids"):
        w, g = np.asarray(getattr(want, f)), getattr(tables, f).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert (tables.entry, tables.n_levels, tables.packed) == (want.entry, want.n_levels,
                                                             want.packed)
    assert (tables.n, tables.m) == (want.n, want.m)
    assert tables.nbytes() == want.nbytes()


def test_prepare_batched_packed_needs_four_levels():
    _, got, _ = _graphs("ties")
    got.n_levels = 5
    with pytest.raises(ValueError, match="packed HNSW tables need n_levels <= 4, got 5"):
        PH.prepare_batched(got, packed=True, device="cpu")


# (k, ef, beam, max_hops): the CLI's shape; k beyond the reachable set (the
# n64 corpus has 64 documents); beam > ef (clamped to ef); a max_hops that
# cuts the walk; no hop at all
SEARCH_CASES = [(10, 64, 8, 64), (80, 96, 16, 64), (10, 16, 32, 64), (10, 32, 4, 3),
                (5, 8, 2, 0)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", ["n400", "n64", "empty slots"])
def test_batched_search_equals_reference(name, packed):
    ref, got, cq = _graphs(name, packed=packed)
    want_t, tables = RH.prepare_batched(ref), PH.prepare_batched(got, device="cpu")
    for k, ef, beam, max_hops in SEARCH_CASES:
        kw = dict(k=k, ef=ef, beam=beam, max_hops=max_hops, with_stats=True)
        want = RH.search_hnsw_batched(want_t, jnp.asarray(cq), backend="xla", **kw)
        got_out = PH.search_hnsw_batched(tables, _t(cq), **kw)
        _same(want, got_out)
        _same_stats(want[2], got_out[2])
        assert got_out[0].shape == (cq.shape[0], k)
        if k > WORLDS[name][0]:
            assert (got_out[1] == -1).any()


@pytest.mark.parametrize("name", ["n400", "n64"])
def test_full_budget_equals_early_exit(name):
    """Past the hop where no query is active nothing changes: the full
    budget (no host read, a gather every hop) gives the early exit's bits."""
    _, got, cq = _graphs(name)
    tables = PH.prepare_batched(got, device="cpu")
    kw = dict(k=10, ef=32, beam=8, max_hops=40, with_stats=True)
    PH.hnsw_frontier_search.host_reads = 0
    early = PH.search_hnsw_batched(tables, _t(cq), **kw)
    iters = int(early[2]["hops"].max())
    assert 0 < iters < 40 and PH.hnsw_frontier_search.host_reads == iters + 1
    PH.hnsw_frontier_search.host_reads = 0
    full = PH.search_hnsw_batched(tables, _t(cq), early_exit=False, **kw)
    assert PH.hnsw_frontier_search.host_reads == 0
    _same(early, full)
    _same_stats({k: v.numpy() for k, v in early[2].items()}, full[2])


@pytest.mark.parametrize("start", ["doc 0", "a node next to doc 0"])
def test_beam_holding_doc_zero_beside_invalid_slots(start):
    """Every invalid slot of a beam or a candidate block clamps to doc 0.
    A walk from doc 0 alone puts it in a beam beside 7 invalid slots; a walk
    from a node whose neighbours include doc 0 makes doc 0 a fresh candidate
    beside invalid slots. Repeated indices must not lose its mark: the walk
    equals the reference's, stats included."""
    ref, got, cq = _graphs("n400")
    first = 0 if start == "doc 0" else int(np.nonzero((got.neighbors == 0).any(1))[0][0])
    assert first == 0 or 0 in got.neighbors[first]
    entries = np.array([first] + [-1] * 7, np.int32)
    kw = dict(n_levels=LEVELS, k=10, ef=32, beam=8, max_hops=64, packed=False)
    rt, pt = RH.prepare_batched(ref), PH.prepare_batched(got, device="cpu")
    want = RH.hnsw_frontier_search(jnp.asarray(cq), rt.codes, rt.inv_norm, rt.nbr_codes,
                                   rt.nbr_inv, rt.nbr_ids, jnp.asarray(entries), backend="xla",
                                   **kw)
    out = PH.hnsw_frontier_search(_t(cq), pt.codes, pt.inv_norm, pt.nbr_codes, pt.nbr_inv,
                                  pt.nbr_ids, _t(entries), backend="torch", **kw)
    _same(want, out)
    _same_stats(want[2], out[2])
    for row in out[1].tolist():
        live = [i for i in row if i >= 0]
        assert len(set(live)) == len(live)


def _knob(level):
    knob = PP.EffortKnob(n_levels=10)
    for _ in range(level):
        knob.degrade()
    return knob


SNAPSHOT_CASES = [  # (rerank, effort level, packed)
    (None, None, False), (None, 0, False), (None, 1, True), (None, 2, False),
    ((2, 24), None, False), ((2, 24), None, True), ((2, 24), 0, True), ((2, 24), 2, False),
    ((3, 40), 9, True), ((1, 16), None, False),
]


@pytest.mark.parametrize("rerank, level, packed", SNAPSHOT_CASES)
def test_snapshot_closure_equals_reference(reference_norms, rerank, level, packed):
    """Effort levels 0-2 (ef and beam halved per level; with rerank, k'
    halved first, level 9 its floor) and the bi-granular rerank, the fine
    tier a numpy array; level 0 is the closure without a knob."""
    cd, cq, _ = _world("n400")
    snap = types.SimpleNamespace(codes=cd, n_levels=LEVELS)
    rr = None if rerank is None else {"coarse_levels": rerank[0], "k_coarse": rerank[1]}
    knob = None if level is None else _knob(level)
    kw = dict(k=5, M=8, ef_construction=32, ef=32, beam=8, max_hops=32, packed=packed,
              rerank=rr, effort=knob)
    ref = RH.hnsw_search_from_snapshot(snap, backend="xla", **kw)
    got = PH.hnsw_search_from_snapshot(snap, device="cpu", **kw)
    assert getattr(got, "reranked", False) == getattr(ref, "reranked", False)
    assert getattr(got, "effort", None) is getattr(ref, "effort", None)
    _same(ref(jnp.asarray(cq)), got(_t(cq)))
    if level == 0:
        plain = PH.hnsw_search_from_snapshot(snap, device="cpu", **{**kw, "effort": None})
        _same(_np(plain(_t(cq))), got(_t(cq)))


def test_snapshot_closure_takes_a_tensor_tier(reference_norms):
    """Tensor codes: the fine tier stays a tensor on the device; the same bits."""
    cd, cq, _ = _world("n400")
    kw = dict(k=5, M=8, ef_construction=32, ef=32, rerank={"coarse_levels": 2, "k_coarse": 24})
    want = RH.hnsw_search_from_snapshot(cd, LEVELS, backend="xla", **kw)(jnp.asarray(cq))
    _same(want, PH.hnsw_search_from_snapshot(_t(cd), LEVELS, device="cpu", **kw)(_t(cq)))


def _np(out):
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_leaves", [1, 4])
def test_build_hnsw_sharded_equals_reference(n_leaves, packed):
    cd, _, inv = _world("n400")
    kw = dict(n_leaves=n_leaves, n_levels=LEVELS, M=8, ef_construction=16, n_entries=6, seed=2,
              packed=packed)
    want = RH.build_hnsw_sharded(cd, inv, **kw)
    got = PH.build_hnsw_sharded(cd, inv, device="cpu", **kw)
    for f in ("codes", "inv_norm", "nbr_codes", "nbr_inv", "nbr_ids", "entries"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert (got.n_levels, got.packed) == (want.n_levels, want.packed)
    with pytest.raises(ValueError, match="corpus size 400 not divisible by 3 leaves"):
        PH.build_hnsw_sharded(cd, inv, n_leaves=3, n_levels=LEVELS, device="cpu")


CLI = ["--device", "cpu", "--index", "hnsw", "--docs", "600", "--queries", "32", "--dim", "32",
       "--code-dim", "16", "--batch", "16", "--rounds", "1", "--ef", "32", "--beam", "4"]


@pytest.mark.parametrize("extra", [[], ["--packed"], ["--coarse-levels", "2", "--k-coarse", "64"]])
def test_cli_serves_hnsw_on_the_cpu(capsys, extra):
    PSV.main(CLI + extra)
    out = capsys.readouterr().out
    assert "[index] building NSW graph (host-side, O(N^2) incremental construction" in out
    assert "[index] hnsw: " in out and "MiB (float flat: " in out
    assert "[serve] recall@10" in out and "[serve] pipelined" in out
    if extra and extra[0] == "--coarse-levels":
        assert "[index] bi-granular tiers (serialized): coarse" in out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run there")
    codes = np.random.default_rng(0).integers(0, 16, (40, 16)).astype(np.int8)
    inv = PR.doc_inv_norms(_t(codes), LEVELS).numpy()
    graph = PH.build_hnsw(codes, inv, n_levels=LEVELS, M=4)  # numpy, on the host
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PH.prepare_batched(graph)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PH.build_hnsw_sharded(codes, inv, n_leaves=2, n_levels=LEVELS, M=4)
    for rerank in (None, {"coarse_levels": 2, "k_coarse": 8}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PH.hnsw_search_from_snapshot(codes, LEVELS, k=5, M=4, rerank=rerank)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSV.main(["--index", "hnsw", "--docs", "10"])
    tables = PH.prepare_batched(graph, device="cpu")
    with pytest.raises(ValueError, match="backend 'cuda' needs CUDA tensors"):
        PH.search_hnsw_batched(tables, _t(codes[:2]), k=3, backend="cuda")


# ---------------------------------------------------------------------------
# On the card: the kernels' walk equal to the plain version's.
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_graph(n=3001, q=37, d=128, levels=LEVELS, M=16):
    rng = np.random.default_rng(n + d)
    cd = rng.integers(0, 2**levels, (n, d)).astype(np.int8)
    cq = rng.integers(0, 2**levels, (q, d)).astype(np.int8)
    inv = PR.doc_inv_norms(_t(cd), levels).numpy()
    return cd, cq, PH.build_hnsw(cd, inv, n_levels=levels, M=M, ef_construction=32)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k, ef, beam, max_hops", SEARCH_CASES[:4] + [(10, 200, 8, 64)])
def test_walk_on_card_equals_plain(card, monkeypatch, packed, k, ef, beam, max_hops):
    cd, cq, graph = _card_graph()
    tables = PH.prepare_batched(graph, packed=packed, device=card)
    kw = dict(k=k, ef=ef, beam=beam, max_hops=max_hops, with_stats=True)
    want = PH.search_hnsw_batched(tables, _t(cq), backend="torch", **kw)
    cpu = PH.search_hnsw_batched(PH.prepare_batched(graph, packed=packed, device="cpu"),
                                 _t(cq), **kw)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(PG, "sdc_gather_topk_torch", plain)
    monkeypatch.setattr(PS, "sdc_topk_torch", plain)
    before = PS.sdc_topk.launches, PG.sdc_gather_topk.launches
    got = PH.search_hnsw_batched(tables, _t(cq), **kw)
    iters = int(got[2]["hops"].max())
    assert (PS.sdc_topk.launches, PG.sdc_gather_topk.launches) == (before[0] + 1,
                                                                   before[1] + iters)
    for a, b, c in zip(got[:2], want[:2], cpu[:2]):
        assert a.device.type == "cuda" and torch.equal(a, b) and torch.equal(a.cpu(), c)
    for key in ("hops", "scored"):
        assert torch.equal(got[2][key], want[2][key])


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 1])
def test_beam_holding_doc_zero_on_card(card, start):
    cd, cq, graph = _card_graph()
    first = 0 if start == 0 else int(np.nonzero((graph.neighbors == 0).any(1))[0][0])
    entries = torch.tensor([first] + [-1] * 7)
    outs = []
    for dev, backend in ((card, "cuda"), (card, "torch"), ("cpu", "torch")):
        t = PH.prepare_batched(graph, device=dev)
        outs.append(PH.hnsw_frontier_search(
            _t(cq).to(dev), t.codes, t.inv_norm, t.nbr_codes, t.nbr_inv, t.nbr_ids, entries,
            n_levels=LEVELS, k=10, ef=64, beam=8, max_hops=64, backend=backend, packed=False))
    for out in outs[1:]:
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(outs[0][:2], out[:2]))
        assert all(torch.equal(outs[0][2][x].cpu(), out[2][x].cpu()) for x in ("hops", "scored"))


@pytest.mark.gpu
@pytest.mark.parametrize("rerank", [None, {"coarse_levels": 2, "k_coarse": 64}])
def test_snapshot_closure_on_card_equals_plain(card, rerank):
    cd, cq, _ = _card_graph(n=2003)
    kw = dict(k=10, packed=True, rerank=rerank)
    plain = PH.hnsw_search_from_snapshot(cd, LEVELS, backend="torch", device=card, **kw)(cq)
    for codes in (cd, _t(cd).to(card)):  # a host fine tier, a device one
        got = PH.hnsw_search_from_snapshot(codes, LEVELS, device=card, **kw)(_t(cq))
        assert got[0].device.type == "cuda"
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
