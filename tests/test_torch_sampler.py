"""The neighbor sampler in the PyTorch port (``repro_torch/models/sampler.py``)
against the JAX package's (``repro/models/sampler.py``): numpy on the host
in both, so the same graph and ``np.random.Generator`` state must give
the same arrays bit for bit (values, dtypes and shapes), and the
generator must be left in the same state."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.models import sampler as R  # noqa: E402
from repro_torch.models import sampler as P  # noqa: E402


def _edges(n, e, seed, isolated=0):
    """A random multigraph on n nodes; the last ``isolated`` nodes send no edge."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - isolated, e)
    r = rng.integers(0, n, e)
    return s, r


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,e,seed", [(200, 1500, 0), (50, 40, 1), (1, 3, 2), (300, 0, 3)])
def test_csr_matches_the_reference(n, e, seed):
    s, r = _edges(n, e, seed)
    a, b = R.CSRGraph.from_edges(s, r, n), P.CSRGraph.from_edges(s, r, n)
    assert a.n_nodes == b.n_nodes == n
    _equal((a.indptr, a.indices), (b.indptr, b.indices))


CASES = [
    # (n, edges, isolated senders, seeds, fanouts, rng seed)
    (200, 1500, 0, np.arange(16), [5, 3], 1),
    (200, 1500, 20, np.array([199, 3, 3, 180, 7]), [4, 2], 7),  # repeats, zero-degree seeds
    (1000, 20000, 0, np.arange(0, 1000, 37), [15, 10], 11),  # minibatch_lg's fanout
    (60, 30, 30, np.arange(40, 60), [3], 5),  # every seed has degree 0
    (80, 900, 0, np.arange(8), [2, 2, 2], 13),  # three hops
    (500, 6000, 0, np.arange(64), [25, 10], 17),  # fanouts above most degrees
]


@pytest.mark.parametrize("n,e,isolated,seeds,fanouts,seed", CASES)
def test_sample_subgraph_bit_for_bit(n, e, isolated, seeds, fanouts, seed):
    s, r = _edges(n, e, seed, isolated)
    g_ref, g_port = R.CSRGraph.from_edges(s, r, n), P.CSRGraph.from_edges(s, r, n)
    rng_ref, rng_port = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):  # successive draws from one generator
        want = R.sample_subgraph(g_ref, seeds, fanouts, rng_ref)
        got = P.sample_subgraph(g_port, seeds, fanouts, rng_port)
        _equal(got, want)
    assert rng_port.bit_generator.state == rng_ref.bit_generator.state
    nodes, ss, rr, mask, pos = got
    assert ss.shape[0] >= P.max_sampled_edges(len(seeds), fanouts)
    np.testing.assert_array_equal(nodes[pos], seeds)


@pytest.mark.parametrize("batch,fanouts", [(1024, [15, 10]), (16, [5, 3]), (7, []), (3, [1, 1, 1])])
def test_max_sampled_edges_matches_the_reference(batch, fanouts):
    assert P.max_sampled_edges(batch, fanouts) == R.max_sampled_edges(batch, fanouts)
