"""The port's seeded k-means and IVF against the JAX reference's, on the CPU.

``kmeans_pp_init`` draws the reference's keys and uniforms (``prng``) and
maps each target onto an exact int64 cumulative sum, where the reference
searches its float32 one: a pick differs only where the target falls
within the two sums' rounding of a bucket edge. Over seeds 0-19 on a
clustered code set (600 rows, 16 picks each) every pick is counted; all
320 are the reference's, and the test allows no more than ``EDGE_PICKS``
to differ. At the serve CLI's IVF (20,000 documents of
``clustered_corpus(0, ...)`` encoded by the reference's binarizer trained
as the CLI trains it, 300 steps of seed 0; nlist 64, 20 k-means
iterations, seed 1) the port's centroids, list lengths, list members and
``search`` ids equal the reference's. On the codes of the CLI's
``--steps 0`` (the untrained binarizer) pick 4 of 64 is an edge pick,
and the test holds that it is one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import binarize_lib as RB  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro.index import ivf as RI  # noqa: E402
from repro.index import kmeans as RK  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.index import ivf as PI  # noqa: E402
from repro_torch.index import kmeans as PK  # noqa: E402

LEVELS = 4
EDGE_PICKS = 0  # k-means++ picks over seeds 0-19 that may differ (measured: 0 of 320)


def _clustered_values(seed, n, D):
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 2**LEVELS, (6, D))
    noise = rng.integers(-2, 3, (n, D))
    codes = np.clip(centres[rng.integers(0, 6, n)] + noise, 0, 2**LEVELS - 1).astype(np.int8)
    return np.array(RB.codes_to_values(jnp.asarray(codes), LEVELS))


def test_kmeans_pp_picks_equal_the_reference_over_20_seeds():
    x = _clustered_values(11, 600, 32)
    k, differ = 16, 0
    for seed in range(20):
        want = np.asarray(RK.kmeans_pp_init(jax.random.PRNGKey(seed), jnp.asarray(x), k))
        got = PK.kmeans_pp_init(prng.key(seed, "cpu"), torch.from_numpy(x), k).numpy()
        differ += int((want != got).any(-1).sum())
    print(f"k-means++ picks differing from the reference: {differ} of {20 * k}")
    assert differ <= EDGE_PICKS


@pytest.mark.parametrize("pp_init", [True, False])
def test_kmeans_from_the_seed_equals_the_reference(pp_init):
    x = _clustered_values(12, 500, 32)
    rc, ra = RK.kmeans(jax.random.PRNGKey(4), jnp.asarray(x), k=8, iters=10, pp_init=pp_init)
    pc, pa = PK.kmeans(x, k=8, iters=10, seed=4, pp_init=pp_init, device="cpu")
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=1e-5, atol=1e-6)
    assert np.array_equal(pa.numpy(), np.asarray(ra))


DIM, CODE_DIM = 256, 128  # the serve CLI's widths


def _cli_corpus():
    docs, queries, _ = RS.clustered_corpus(0, 20000, 64, DIM)
    bcfg = RB.BinarizerConfig(input_dim=DIM, code_dim=CODE_DIM, n_levels=LEVELS,
                              hidden_dim=2 * DIM)
    return docs, queries, bcfg


@pytest.fixture(scope="module")
def cli_ivf(tmp_path_factory):
    """The reference CLI's IVF build at its defaults (``--index ivf``: 300
    training steps of seed 0, then ``build_ivf(PRNGKey(1), ...)``) and the
    port's on the same codes."""
    import repro.core.losses as RL
    from repro.core.trainer import TrainConfig
    from repro.launch import serve as RSV
    from repro.train import optim as RO

    docs, queries, bcfg = _cli_corpus()
    tcfg = TrainConfig(binarizer=bcfg, queue=RL.QueueConfig(length=4096, dim=CODE_DIM, top_k=64),
                       adam=RO.AdamConfig(lr=2e-3, clip_norm=5.0))
    st = RSV.train_binarizer(docs, tcfg, steps=300,
                             cache_dir=str(tmp_path_factory.mktemp("ref_ckpt")))
    encode = RB.make_encode_fn(st.params, st.bn_state, bcfg)
    codes, qcodes = np.asarray(encode(docs)), np.asarray(encode(queries))
    ref = RI.build_ivf(jax.random.PRNGKey(1), jnp.asarray(codes), n_levels=LEVELS, nlist=64,
                       kmeans_iters=20)
    port = PI.build_ivf(codes, n_levels=LEVELS, nlist=64, kmeans_iters=20, seed=1,
                        device="cpu")
    return ref, port, qcodes


def test_cli_ivf_lists_equal_the_reference(cli_ivf):
    ref, port, _ = cli_ivf
    np.testing.assert_array_equal(port.centroids.numpy(), np.asarray(ref.centroids))
    np.testing.assert_array_equal(port.centroid_codes.numpy(), np.asarray(ref.centroid_codes))
    np.testing.assert_array_equal(port.list_occupancy, np.asarray(ref.list_occupancy))
    np.testing.assert_array_equal(port.lists_ids.numpy(), np.asarray(ref.lists_ids))
    np.testing.assert_array_equal(port.lists_codes.numpy(), np.asarray(ref.lists_codes))


def test_cli_ivf_search_ids_equal_the_reference(cli_ivf):
    ref, port, qcodes = cli_ivf
    _, want = RI.search(ref, jnp.asarray(qcodes), nprobe=32, k=10, backend="xla")
    _, got = PI.search(port, torch.from_numpy(qcodes), nprobe=32, k=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_untrained_cli_codes_differ_at_one_edge_pick():
    """On the codes the CLI serves with ``--steps 0`` (the initial binarizer
    of seed 0) the picks of seed 1 part at pick 4, and only there by
    choice: the reference's target 1 - u lies within float32 rounding of
    the exact cumulative edge between the two rows it and the port pick.
    Every later pick then follows other distances (the counts printed)."""
    docs, _, bcfg = _cli_corpus()
    params, state = RB.init_binarizer(jax.random.PRNGKey(0), bcfg)
    codes = np.asarray(RB.make_encode_fn(params, state, bcfg)(docs))
    x = np.array(RB.codes_to_values(jnp.asarray(codes), LEVELS))
    want = np.asarray(RK.kmeans_pp_init(jax.random.PRNGKey(1), jnp.asarray(x), 64))
    got = PK.kmeans_pp_init(prng.key(1, "cpu"), torch.from_numpy(x), 64).numpy()
    differ = (want != got).any(-1)
    i = int(np.argmax(differ))
    print(f"k-means++ on the --steps 0 codes: picks 0-{i - 1} equal, "
          f"{int(differ.sum())} of 64 differ from pick {i} on")
    assert differ.any() and i == 4
    # the draw of pick i: the reference's key chain, its uniform, the exact sums
    key = jax.random.split(jax.random.PRNGKey(1))[1]
    for _ in range(i):
        key, kk = jax.random.split(key)
    target = 1.0 - float(jax.random.uniform(kk, (), jnp.float32))
    mind = np.min([np.sum((x.astype(np.float64) - c) ** 2, -1) for c in want[:i]], axis=0)
    cum = np.cumsum(mind) / mind.sum()
    rows = sorted(int(np.nonzero((x == c).all(-1))[0][0]) for c in (want[i], got[i]))
    assert np.all(mind[rows[0] + 1:rows[1]] == 0)  # neighbours in the cumulative order
    assert abs(cum[rows[0]] - target) < 2.0 ** -22  # float32's rounding near 0.84
