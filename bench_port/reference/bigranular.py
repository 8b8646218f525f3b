"""Bi-granular exhaustive search (the ``bigranular`` index kind): a
coarse SDC scan over the codes' first ``coarse_levels`` levels keeps each
query's top ``k_coarse`` documents, which are ranked again by their
full-level SDC score; the top k of those are the answer. Both rankings
break ties toward the lower id."""

from __future__ import annotations

import torch

from bench_port.reference import sdc
from bench_port.reference.stream import RunningTopK


def index_arrays(cfg: dict, codes: torch.Tensor) -> dict:
    """What a bi-granular index holds for documents of integer codes [n, D]:
    the full-level codes and norms, and the coarse tier's."""
    L, C = cfg["n_levels"], cfg["coarse_levels"]
    c = sdc.coarse(codes, L, C)
    return {"codes": codes, "inv": sdc.inv_norms(codes, L),
            "coarse": c, "coarse_inv": sdc.inv_norms(c, C)}


class Search:
    """The search of query codes [Q, D] over chunks given in id order."""

    def __init__(self, cfg: dict, q_codes: torch.Tensor):
        self.cfg, self.q = cfg, q_codes
        self.qc = sdc.coarse(q_codes, cfg["n_levels"], cfg["coarse_levels"])
        self.top = RunningTopK(cfg["k_coarse"])

    def add(self, start: int, arrays: dict, carried=()) -> torch.Tensor:
        """Scan one chunk; returns its full-level scores [Q, n], by which
        the survivors rank."""
        cfg = self.cfg
        sc = sdc.scores(self.qc, arrays["coarse"], arrays["coarse_inv"], cfg["coarse_levels"])
        sf = sdc.scores(self.q, arrays["codes"], arrays["inv"], cfg["n_levels"])
        ids = torch.arange(start, start + sc.shape[1], device=sc.device)
        self.top.add(sdc.order_keys(sc, ids.expand_as(sc)), [sf, *carried])
        return sf

    def result(self):
        """(scores [Q, k], ids [Q, k], the carried values at those ids)."""
        _, ids = sdc.decode_keys(self.top.keys)
        sf, *carried = self.top.carried
        keys = sdc.order_keys(sf, ids)
        top, at = torch.topk(keys, min(self.cfg["k"], keys.shape[1]), dim=1)
        s, ids = sdc.decode_keys(top)
        return s, ids, [torch.gather(c, 1, at) for c in carried]
