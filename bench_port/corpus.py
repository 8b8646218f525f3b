"""The corpus and the query pool of a run, made from ``--seed``.

Documents are clustered: a document is a random cluster center plus
Gaussian noise; with ``spectrum`` > 0 each axis is then scaled by
1/(1+i)^spectrum and the result rotated by a random orthogonal matrix (the
anisotropic geometry of real backbone embeddings); rows are unit norm.
Queries are noisy views of corpus documents, drawn the same way from
their document's pre-rotation vector. This is the recipe of the paper's
web and video settings as the repo's CPU benchmarks drew them, rewritten
to run on the device.

Documents are made ``chunk`` at a time, chunk c from a generator of its
own, so the float corpus is never whole in memory and any chunk can be
made again, bit for bit, after the measured window. The small draws
(centers, rotation, which documents the queries view) are made on the
host with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.binarizer import no_tf32

_SALT_CHUNK, _SALT_QUERY = 1, 2


def _seed(seed: int, *salt: int) -> int:
    ss = np.random.SeedSequence([seed % 2**64, *salt])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Corpus:
    """``cfg`` keys: n_docs, input_dim, chunk, and ``corpus`` = {clusters,
    noise, query_noise, spectrum, query_pool}."""

    def __init__(self, cfg: dict, seed: int, device):
        self.n, self.dim, self.chunk = cfg["n_docs"], cfg["input_dim"], cfg["chunk"]
        c = cfg["corpus"]
        self.noise, self.query_noise = c["noise"], c["query_noise"]
        self.pool = c["query_pool"]
        self.seed, self.device = seed, torch.device(device)
        self._rows = torch.empty((self.pool, self.dim), device=self.device)
        rng = np.random.default_rng(_seed(seed, 0))
        centers = rng.normal(size=(c["clusters"], self.dim)).astype(np.float32)
        mix = np.eye(self.dim, dtype=np.float32)
        if c["spectrum"] > 0:
            scales = (1.0 / (1.0 + np.arange(self.dim)) ** c["spectrum"]).astype(np.float32)
            rot, _ = np.linalg.qr(rng.normal(size=(self.dim, self.dim)))
            mix = (scales[:, None] * rot).astype(np.float32)
        # The documents the pool's queries view, in pool order.
        self.query_docs = rng.integers(0, self.n, self.pool)
        self.centers = torch.from_numpy(centers).to(self.device)
        self.mix = torch.from_numpy(mix).to(self.device)

    @property
    def n_chunks(self) -> int:
        return -(-self.n // self.chunk)

    def bounds(self, c: int):
        return c * self.chunk, min(self.n, (c + 1) * self.chunk)

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            y = torch.matmul(x, self.mix)
        return y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-12)

    def raw(self, c: int) -> torch.Tensor:
        """Chunk c's documents before rotation and normalisation."""
        s, e = self.bounds(c)
        g = torch.Generator(device=self.device).manual_seed(_seed(self.seed, _SALT_CHUNK, c))
        assign = torch.randint(0, self.centers.shape[0], (e - s,), generator=g,
                               device=self.device)
        eps = torch.randn((e - s, self.dim), generator=g, device=self.device)
        return self.centers[assign] + self.noise * eps

    def docs(self, c: int, raw: torch.Tensor | None = None) -> torch.Tensor:
        """Chunk c's documents [n, dim], float32 unit rows, on the device."""
        return self._finish(self.raw(c) if raw is None else raw)

    def collect(self, c: int, raw: torch.Tensor) -> None:
        """Keep the pre-rotation rows of the pool's documents in chunk c
        (``raw``); every chunk passes through here once before ``queries``."""
        s, e = self.bounds(c)
        at = np.nonzero((self.query_docs >= s) & (self.query_docs < e))[0]
        if len(at):
            rows = torch.as_tensor(self.query_docs[at] - s, device=self.device)
            self._rows[torch.as_tensor(at, device=self.device)] = raw[rows]

    def queries(self) -> np.ndarray:
        """The query pool [pool, dim], host float32, in pool order."""
        g = torch.Generator(device=self.device).manual_seed(_seed(self.seed, _SALT_QUERY))
        eps = torch.randn(self._rows.shape, generator=g, device=self.device)
        return self._finish(self._rows + self.query_noise * eps).cpu().numpy()
