"""k-means (Lloyd) with k-means++ seeding (ports ``repro/index/kmeans.py``).

The IVF coarse quantiser. The draws are the reference's: ``prng.key(seed)``
split as ``repro/index/kmeans.py`` splits its key, the first pick
``randint(k0, (), 0, n)``, each later one the target ``total * (1 -
uniform(kk))`` of ``choice(kk, n, p=probs)``, and ``pp_init=False`` the
first k of ``permutation(key, n)``. ``init=`` takes starting centroids.

Rebuilds must be bit-identical (the same snapshot and seed give the same
index), so every reduction here has a fixed order on the card as well:
cluster sums are a one-hot matrix product per chunk of rows, in float32
with TF32 off, added chunk after chunk in row order (``index_add_``/
``scatter_add_`` on float use atomics, whose order changes from run to
run). Within a chunk the product is exact, whatever order cuBLAS sums
in, while a cluster's partial sum stays below 2^24 grid units: on grids
of up to 4 levels (multiples of 2^-3, at most 15 units in magnitude) a
chunk of 2^20 rows stays below 15 * 2^20. On finer grids, or other
inputs, a chunk's sums may round, and a bit-identical rebuild then rests
on cuBLAS giving the same bits for the same shapes on the same card, as
the distance product does on every grid. The
k-means++ draw is an inverse-CDF lookup, which has no category limit
(``torch.multinomial`` takes at most 2^24). Its cumulative sum is taken
over integer weights (each distance in units of 2^-32 of the largest),
because a floating-point ``cumsum`` on CUDA is not deterministic and a
float32 one loses resolution over ten million points; int64 sums are
exact in any order. The reference's target, a float32 fraction 1 - u of
its float32 cumulative sum, maps onto the integer one exactly, so a
pick differs from the reference's only where the target falls within
the two sums' rounding of a bucket edge.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import prng
from repro_torch.device import full_fp32_matmul, resolve_device

_CHUNK = 1 << 20  # rows per distance / one-hot product


def _pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, D] x [K, D] -> [N, K] squared euclidean distances."""
    full_fp32_matmul()
    x2 = torch.sum(x * x, -1, keepdim=True)
    c2 = torch.sum(c * c, -1)
    return x2 + c2[None, :] - 2.0 * (x @ c.t())


def kmeans_pp_init(key: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding: k rows of x, each drawn with probability
    proportional to its squared distance to the nearest row drawn so far,
    from the reference's splits of ``key``. The keys and uniforms are
    drawn on the host (a scalar each), so a pick costs no host read."""
    n = x.shape[0]
    dev = x.device
    host = key.to("cpu")
    k0, host = prng.split(host)
    first = int(prng.randint(k0, (), 0, n))
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=dev)
    cents[0] = x[first]
    mind = torch.sum((x - x[first]) ** 2, -1)
    for i in range(1, k):
        host, kk = prng.split(host)
        idx = _draw(float(prng.uniform(kk)), mind)
        cents[i:i + 1] = x[idx]
        mind = torch.minimum(mind, torch.sum((x - x[idx]) ** 2, -1))
    return cents


def _draw(u: float, weights: torch.Tensor) -> torch.Tensor:
    """The index [1] that ``choice(n, p=weights / sum)`` picks for the float32
    uniform ``u``: the first whose cumulative weight reaches the fraction
    1 - u of the total, on the integer sum (the same on every run)."""
    scale = 2.0**32 / torch.clamp(weights.max().to(torch.float64), min=1e-300)
    cdf = torch.cumsum(torch.floor(weights.to(torch.float64) * scale).to(torch.int64), 0)
    # 1 - u = m / 2^23 exactly; target = ceil(m * total / 2^23), split so
    # that no product leaves int64.
    m = (1 << 23) - int(round(u * (1 << 23)))
    total = cdf[-1:]
    q, r = total >> 23, total & ((1 << 23) - 1)
    target = q * m + ((r * m + (1 << 23) - 1) >> 23)
    return torch.searchsorted(cdf, target).clamp_(max=weights.shape[0] - 1)


def _assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of every row, ties to the lower index (as ``jnp.argmin``)."""
    return torch.cat([torch.argmin(_pairwise_sqdist(x[s:s + _CHUNK], cents), dim=-1)
                      for s in range(0, x.shape[0], _CHUNK)])


def _cluster_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """Per-cluster row sums [k, D] and counts [k], in a fixed order."""
    full_fp32_matmul()
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device)
    labels = torch.arange(k, device=x.device)
    for s in range(0, x.shape[0], _CHUNK):
        onehot = (assign[s:s + _CHUNK, None] == labels).to(x.dtype)
        sums += onehot.t() @ x[s:s + _CHUNK]
        counts += onehot.sum(0)
    return sums, counts


def kmeans(x, *, k: int, iters: int = 25, seed: int = 0, init=None, pp_init: bool = True,
           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means on ``device``: (centroids [k, D] f32, assignments [N] int64).

    Starts from ``init`` [k, D] when given, else from ``prng.key(seed)``:
    k-means++ picks, or with ``pp_init=False`` the rows ``choice(key, N,
    (k,), replace=False)``. An empty cluster keeps its centroid. The
    assignments are those of the returned centroids.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev, torch.float32)
    if init is None and pp_init:
        cents = kmeans_pp_init(prng.key(seed, dev), x, k)
    elif init is None:
        cents = x[prng.choice(prng.key(seed, dev), x.shape[0], (k,), replace=False)]
    else:
        cents = torch.as_tensor(init).to(dev, torch.float32).clone()
    for _ in range(iters):
        sums, counts = _cluster_sums(x, _assign(x, cents), k)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents, _assign(x, cents)
