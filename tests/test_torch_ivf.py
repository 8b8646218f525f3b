"""The IVF slice of the PyTorch port against the JAX reference.

Small sizes on the CPU (a few hundred documents, code dim 32/64, nlist
8). k-means: started from the reference's own k-means++ picks, the
port's Lloyd steps must land within rtol 1e-5 / atol 1e-6 of the
reference's centroids (sums of grid values are exact in float32, so only
the order of the distance products can differ), with the assignments
that differ counted and bounded. Bucketing: from the reference's
assignments and inverse norms the port's lists must be bit-identical,
overflow warning included. Search: on a reference index carried across
with ``ivf_from_numpy``, ``search`` and ``search_budget`` with
``coarse_sdc=True`` must be bit-identical to the reference's "xla"
backend; with float centroids the probes are compared first and results
must be bit-identical wherever they agree.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.index import ivf as RI  # noqa: E402
from repro.index import kmeans as RK  # noqa: E402
from repro.kernels.sdc import ref as RR  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import binarize_lib as PB  # noqa: E402
from repro_torch.index import ivf as PI  # noqa: E402
from repro_torch.index import kmeans as PK  # noqa: E402
from repro_torch.launch import serve as PSV  # noqa: E402

LEVELS, NLIST, ITERS = 4, 8, 5
FIELDS = ("centroids", "centroid_codes", "lists_codes", "lists_inv_norm", "lists_ids")


def _codes(seed, n, D, n_levels=LEVELS):
    # clustered codes, so the lists differ in occupancy
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 2**n_levels, (6, D))
    noise = rng.integers(-2, 3, (n, D))
    return np.clip(centres[rng.integers(0, 6, n)] + noise, 0, 2**n_levels - 1).astype(np.int8)


@pytest.fixture(scope="module")
def ref_indexes():
    codes = _codes(0, 600, 64)
    out = {}
    for packed in (False, True):
        out[packed] = RI.build_ivf(jax.random.PRNGKey(1), jnp.asarray(codes), n_levels=LEVELS,
                                   nlist=NLIST, kmeans_iters=ITERS, packed=packed)
    q = np.random.default_rng(1).integers(0, 16, (64, 64)).astype(np.int8)
    return codes, out, q


def _carry(ref):
    return PI.ivf_from_numpy(**{f: np.array(getattr(ref, f)) for f in FIELDS},
                             n_levels=ref.n_levels, packed=ref.packed,
                             list_occupancy=ref.list_occupancy, device="cpu")


def _same(ref, got):
    rv, ri = (np.asarray(x) for x in ref)
    gv, gi = (x.numpy() for x in got)
    assert np.array_equal(rv.view(np.uint32), gv.view(np.uint32))
    assert np.array_equal(ri, gi)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_from_the_reference_init(seed):
    x = np.array(RB.codes_to_values(jnp.asarray(_codes(seed, 400, 32)), LEVELS))
    key = jax.random.PRNGKey(seed)
    init = np.array(RK.kmeans_pp_init(key, jnp.asarray(x), NLIST))
    rc, ra = (np.asarray(a) for a in RK.kmeans(key, jnp.asarray(x), k=NLIST, iters=10))
    pc, pa = PK.kmeans(x, k=NLIST, iters=10, init=init, device="cpu")
    np.testing.assert_allclose(pc.numpy(), rc, rtol=1e-5, atol=1e-6)
    differ = int((pa.numpy() != ra).sum())
    assert differ <= len(x) // 100, f"{differ} of {len(x)} assignments differ"


def test_kmeans_pp_init_is_deterministic_and_picks_distinct_rows():
    x = torch.from_numpy(np.array(RB.codes_to_values(jnp.asarray(_codes(3, 300, 32)), 4)))
    a = PK.kmeans_pp_init(prng.key(5, "cpu"), x, NLIST)
    b = PK.kmeans_pp_init(prng.key(5, "cpu"), x, NLIST)
    assert torch.equal(a, b)
    rows = [int(torch.nonzero((x == c).all(-1))[0]) for c in a]  # every pick is a row of x
    assert len({tuple(x[r].tolist()) for r in rows}) == NLIST
    c1, a1 = PK.kmeans(x, k=NLIST, iters=3, seed=2, device="cpu")
    c2, a2 = PK.kmeans(x, k=NLIST, iters=3, seed=2, device="cpu")
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


def test_draw_never_picks_a_zero_weight():
    w = torch.zeros(10_000_000)
    w[[3, 4_000_000, 9_999_999]] = torch.tensor([1.0, 2.0, 1e-6])
    keys = prng.split(prng.key(0, "cpu"), 50)
    picks = {int(PK._draw(float(prng.uniform(k)), w)) for k in keys}
    assert picks <= {3, 4_000_000, 9_999_999} and 4_000_000 in picks


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("max_len,headroom", [(None, 1.0), (60, 1.2)])
def test_bucketing_bit_identical_from_reference_assignments(packed, max_len, headroom):
    codes = _codes(4, 500, 32)
    key = jax.random.PRNGKey(7)
    kw = dict(n_levels=LEVELS, nlist=NLIST, kmeans_iters=ITERS, max_len=max_len,
              headroom=headroom, packed=packed)
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        ref = RI.build_ivf(key, jnp.asarray(codes), **kw)
    _, assign = RK.kmeans(key, RB.codes_to_values(jnp.asarray(codes), LEVELS), k=NLIST,
                          iters=ITERS)
    inv = np.array(RR.doc_inv_norms(jnp.asarray(codes), LEVELS))
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        lc, ln, li, occ = PI.bucket_lists(torch.from_numpy(codes), torch.from_numpy(inv),
                                          torch.from_numpy(np.array(assign)), nlist=NLIST,
                                          max_len=max_len, headroom=headroom)
    assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w]
    if max_len is not None:
        assert "dropped by list overflow" in str(got_w[0].message)
    if packed:
        lc = PB.pack_codes_nibbles(lc)
    assert np.array_equal(lc.numpy(), np.asarray(ref.lists_codes))
    want_inv = np.asarray(ref.lists_inv_norm)
    assert np.array_equal(ln.numpy().view(np.uint32), want_inv.view(np.uint32))
    assert np.array_equal(li.numpy(), np.asarray(ref.lists_ids))
    assert occ.dtype == np.int32 and np.array_equal(occ, ref.list_occupancy)


def test_port_build_is_deterministic_and_keeps_every_doc():
    codes = _codes(5, 700, 32)
    a = PI.build_ivf(codes, n_levels=LEVELS, nlist=NLIST, kmeans_iters=ITERS, seed=3,
                     device="cpu")
    b = PI.build_ivf(codes, n_levels=LEVELS, nlist=NLIST, kmeans_iters=ITERS, seed=3,
                     device="cpu", packed=True)
    for f in FIELDS[:2] + FIELDS[3:]:
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert torch.equal(PB.pack_codes_nibbles(a.lists_codes), b.lists_codes)
    ids = a.lists_ids[a.lists_ids >= 0]
    assert sorted(ids.tolist()) == list(range(700))
    for c in range(NLIST):
        row = a.lists_ids[c][a.lists_ids[c] >= 0].tolist()
        assert row == sorted(row) and len(row) == a.list_occupancy[c]
    assert a.nbytes() == 700 * ((32 * LEVELS + 7) // 8 + 8) + NLIST * 32 * 4
    with pytest.raises(ValueError):
        PI.build_ivf(codes, n_levels=5, nlist=NLIST, packed=True, device="cpu")


@pytest.mark.parametrize("budget", [NLIST // 2, NLIST + NLIST // 2, 3 * NLIST, 5 * NLIST + 7])
@pytest.mark.parametrize("weighted", [False, True])
def test_probe_rank_thresholds_equal_the_reference(budget, weighted):
    occ = np.array([50, 3, 0, 20, 20, 7, 100, 1], np.int32)
    got = PI.probe_rank_thresholds(occ if weighted else None, probe_budget=budget,
                                   nlist=NLIST, weighted=weighted)
    want = RI.probe_rank_thresholds(occ if weighted else None, probe_budget=budget,
                                    nlist=NLIST, weighted=weighted)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("nprobe", [1, 3])
def test_search_bit_identical_with_coarse_sdc(ref_indexes, packed, nprobe):
    _, refs, q = ref_indexes
    ref, port = refs[packed], _carry(refs[packed])
    want = RI.search(ref, jnp.asarray(q), nprobe=nprobe, k=10, coarse_sdc=True, backend="xla")
    _same(want, PI.search(port, torch.from_numpy(q), nprobe=nprobe, k=10, coarse_sdc=True))
    if nprobe == 3 and not packed:  # the Pallas kernel too, in interpret mode
        kv, ki = RI.search(ref, jnp.asarray(q[:8]), nprobe=nprobe, k=10, coarse_sdc=True,
                           backend="interpret")
        pv, pi = PI.search(port, torch.from_numpy(q[:8]), nprobe=nprobe, k=10,
                           coarse_sdc=True)
        assert np.array_equal(np.asarray(kv).view(np.uint32), pv.numpy().view(np.uint32))
        assert np.array_equal(np.asarray(ki), pi.numpy())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("budget,weighted", [(NLIST + NLIST // 2, True),
                                             (2 * NLIST + 3, False), (3 * NLIST, True)])
def test_search_budget_bit_identical_with_coarse_sdc(ref_indexes, packed, budget, weighted):
    _, refs, q = ref_indexes
    ref, port = refs[packed], _carry(refs[packed])
    want = RI.search_budget(ref, jnp.asarray(q), probe_budget=budget, k=10, weighted=weighted,
                            coarse_sdc=True, backend="xla")
    got = PI.search_budget(port, torch.from_numpy(q), probe_budget=budget, k=10,
                           weighted=weighted, coarse_sdc=True)
    _same(want, got)


def test_search_with_float_centroids(ref_indexes):
    _, refs, q = ref_indexes
    ref, port = refs[False], _carry(refs[False])
    nprobe = 3
    vq = RB.codes_to_values(jnp.asarray(q), LEVELS)
    ref_probes = np.asarray(jax.lax.top_k(vq @ ref.centroids.T, nprobe)[1])
    probes = PI.coarse_probes(torch.from_numpy(q), port.centroids, port.centroid_codes,
                              nprobe=nprobe, n_levels=LEVELS).numpy()
    agree = (probes == ref_probes).all(1)
    # ulp-level differences in the coarse product may reorder a near tie
    assert (~agree).sum() <= -(-len(q) // 64), f"probes differ on {(~agree).sum()} queries"
    rv, ri = (np.asarray(a) for a in RI.search(ref, jnp.asarray(q), nprobe=nprobe, k=10,
                                                backend="xla"))
    pv, pi = (a.numpy() for a in PI.search(port, torch.from_numpy(q), nprobe=nprobe, k=10))
    assert np.array_equal(rv[agree].view(np.uint32), pv[agree].view(np.uint32))
    assert np.array_equal(ri[agree], pi[agree])


@pytest.mark.parametrize("weighted", [False, True])
def test_budget_at_nprobe_times_nlist_is_flat_nprobe(ref_indexes, weighted):
    _, refs, q = ref_indexes
    port = _carry(refs[True])
    for nprobe in (1, 2, 5):
        a = PI.search(port, torch.from_numpy(q), nprobe=nprobe, k=10)
        b = PI.search_budget(port, torch.from_numpy(q), probe_budget=nprobe * NLIST, k=10,
                             weighted=weighted)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_carried_index_keeps_the_reference_arrays(ref_indexes):
    _, refs, _ = ref_indexes
    for ref in refs.values():
        port = _carry(ref)
        for f in FIELDS:
            assert np.array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)))
        assert port.nbytes() == ref.nbytes() and port.nlist == ref.nlist
        assert port.code_dim == ref.code_dim


@pytest.mark.parametrize("extra", [[], ["--probe-budget", "80", "--packed"]])
def test_cli_serves_ivf_on_the_cpu(capsys, tmp_path, extra):
    PSV.main(["--index", "ivf", "--device", "cpu", "--docs", "3000", "--batch", "16",
              "--rounds", "2", "--steps", "0", "--ckpt-cache", str(tmp_path), *extra])
    out = capsys.readouterr().out
    assert "[index] ivf:" in out and "MiB" in out
    assert "[serve] recall@10:" in out
    assert "[serve] sequential:" in out and "[serve] routed" in out


def test_cli_refuses_probe_budget_without_ivf(capsys):
    """As the reference CLI does: a probe budget means nothing to a flat index."""
    with pytest.raises(SystemExit) as exc:
        PSV.main(["--index", "flat", "--device", "cpu", "--docs", "300",
                  "--probe-budget", "80"])
    assert exc.value.code == 2
    assert "--probe-budget only applies to --index ivf" in capsys.readouterr().err
