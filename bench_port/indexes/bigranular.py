"""The ``bigranular`` kind: the port's ``BiGranularFlat`` with its fine
tier in host memory, as the serve CLI keeps it. A request scans the
coarse tier on the card for ``k_coarse`` survivors; their full-level rows
are gathered on the host, uploaded and reranked by ``sdc_gather_topk``."""

from __future__ import annotations

from repro_torch.index.flat import BiGranularFlat

KERNEL_SOURCES = ("sdc_topk.cu", "gather_topk.cu")


def build(cfg: dict, codes, device) -> BiGranularFlat:
    """The port's index of integer codes [n, D] (one chunk of documents),
    given to it in host memory so that its fine tier stays there."""
    return BiGranularFlat.build(codes.cpu().numpy(), cfg["n_levels"],
                                coarse_levels=cfg["coarse_levels"], k_coarse=cfg["k_coarse"],
                                packed=cfg["packed"], device=device)


def searcher(index: BiGranularFlat, cfg: dict):
    k = cfg["k"]

    def search(q):
        return index.search(q, k)

    search.reranked = True
    return search


def need(cfg: dict, q: int):
    """(bytes, int8 ops) one search of q queries needs: the coarse scan reads
    every document's code at C bits a dim and its 4-byte norm, the rerank
    each survivor's code at L bits a dim and its norm; the queries' codes
    and the answers (a 4-byte score and id each) once. 2 D ops a (query,
    document) and a (query, survivor)."""
    N, D, L, k = cfg["n_docs"], cfg["code_dim"], cfg["n_levels"], cfg["k"]
    C, kc = cfg["coarse_levels"], cfg["k_coarse"]
    nbytes = N * (D * C / 8 + 4) + q * kc * (D * L / 8 + 4) + q * D * L / 8 + q * k * 8
    return nbytes, 2 * q * N * D + 2 * q * kc * D
