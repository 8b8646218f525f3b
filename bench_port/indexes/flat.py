"""The ``flat`` kind: the port's ``FlatSDC``, one exhaustive scan a request."""

from __future__ import annotations

from repro_torch.index.flat import FlatSDC

KERNEL_SOURCES = ("sdc_topk.cu",)


def build(cfg: dict, codes, device) -> FlatSDC:
    """The port's index of integer codes [n, D] (one chunk of documents)."""
    return FlatSDC.build(codes, cfg["n_levels"], packed=cfg["packed"], device=device)


def searcher(index: FlatSDC, cfg: dict):
    k = cfg["k"]
    return lambda q: index.search(q, k)


def need(cfg: dict, q: int):
    """(bytes, int8 ops) one search of q queries needs: every document's
    code at L bits a dim and its 4-byte norm, the queries' codes and the
    answers (a 4-byte score and id each) once; 2 D ops a (query, document)."""
    N, D, L, k = cfg["n_docs"], cfg["code_dim"], cfg["n_levels"], cfg["k"]
    nbytes = N * (D * L / 8 + 4) + q * D * L / 8 + q * k * 8
    return nbytes, 2 * q * N * D
