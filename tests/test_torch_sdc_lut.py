"""``kernels/sdc/ref.py::sdc_ref_lut`` (the paper's int8 lookup-table
algorithm, a plain CPU reference with no kernel) against the reference's.

Exact: both quantise the same float32 tables in the same op order (round
half to even, clip), the sums of int8 entries are exact in float32, and
the inverse norms are handed over from the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.sdc import ref as R  # noqa: E402
from repro_torch.kernels.sdc import ref as P  # noqa: E402


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("levels,q,n,d", [(4, 7, 300, 32), (2, 7, 300, 32), (4, 1, 50, 128),
                                          (2, 16, 64, 66)])
def test_lut_scores_equal_the_reference(levels, q, n, d, seed):
    rng = np.random.default_rng(100 * levels + seed)
    qc = rng.integers(0, 2**levels, (q, d)).astype(np.int8)
    dc = rng.integers(0, 2**levels, (n, d)).astype(np.int8)
    inv = np.asarray(R.doc_inv_norms(jnp.asarray(dc), levels))
    want = np.asarray(R.sdc_ref_lut(jnp.asarray(qc), jnp.asarray(dc), levels, jnp.asarray(inv)))
    got = P.sdc_ref_lut(torch.from_numpy(qc), torch.from_numpy(dc), levels,
                        torch.from_numpy(inv.copy()))
    assert got.dtype == torch.float32 and got.shape == (q, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("levels", [1, 3])
def test_lut_needs_a_four_bit_layout(levels):
    codes = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="n_levels 2 or 4"):
        P.sdc_ref_lut(codes, codes, levels)
