"""Exact exhaustive SDC search (the ``flat`` index kind): the top-k
documents by score over the whole corpus, ties toward the lower id."""

from __future__ import annotations

import torch

from bench_port.reference import sdc
from bench_port.reference.stream import RunningTopK


def index_arrays(cfg: dict, codes: torch.Tensor) -> dict:
    """What a flat index holds for documents of integer codes [n, D]."""
    return {"codes": codes, "inv": sdc.inv_norms(codes, cfg["n_levels"])}


class Search:
    """The search of query codes [Q, D] over chunks given in id order."""

    def __init__(self, cfg: dict, q_codes: torch.Tensor):
        self.cfg, self.q = cfg, q_codes
        self.top = RunningTopK(cfg["k"])

    def add(self, start: int, arrays: dict, carried=()) -> torch.Tensor:
        """Score one chunk; returns its scores [Q, n], by which results rank."""
        s = sdc.scores(self.q, arrays["codes"], arrays["inv"], self.cfg["n_levels"])
        ids = torch.arange(start, start + s.shape[1], device=s.device)
        self.top.add(sdc.order_keys(s, ids.expand_as(s)), carried)
        return s

    def result(self):
        """(scores [Q, k], ids [Q, k], the carried values at those ids)."""
        s, ids = sdc.decode_keys(self.top.keys)
        return s, ids, self.top.carried
