"""What decides ``correct``: the served answers and the index, held to the
plain reference.

After the window has closed, a sample of the requests it finished, drawn
from the seed, is judged. The reference encodes their queries, and walks
the corpus once, a chunk at a time: it makes the chunk's documents again
from the seed, encodes them, derives their norms (and coarse codes) and
scores the sampled queries against them. The served index is held, row by
row, to the port's own build over the reference's codes of the chunk, so
that the check needs no knowledge of how the port lays out a row. The
numbers compared:

    query_codes   share of sampled queries whose codes (the port's encode
                  in the window) differ from the reference's
    index_rows    share of documents whose row in the served index (any
                  field of any tier: codes, norms) differs, bit for bit,
                  from the port's build over the reference's codes
    score_gap     largest gap between a served score and the reference's
                  score of the same (query, document), over the query's
                  best reference score
    rank_gap      largest amount, on the same scale, by which the j-th
                  served document scores below the reference's j-th best
                  (0 for the exact answer, whatever the order of ties)
    bad_ids       served ids out of range or repeated within an answer
    failed        requests of the window that failed or never came back

The control is the same reference with TF32 products in its encode, put
in the port's place (``control``).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from bench_port import assemble
from bench_port.corpus import Corpus, _seed
from bench_port.reference.binarizer import Binarizer

_SALT_SAMPLE = 4
BIG = 1e30  # stands for an infinite gap in the printed numbers


def sample(requests: Sequence, n_queries: int, seed: int) -> List:
    """Finished requests to judge, drawn from the seed: enough for ``n_queries``."""
    reqs = sorted(requests, key=lambda r: (r.client, r.seq))
    want = min(len(reqs), max(1, math.ceil(n_queries / max(1, reqs[0].n_queries)))) if reqs else 0
    rng = np.random.default_rng(_seed(seed, _SALT_SAMPLE))
    return [reqs[i] for i in sorted(rng.choice(len(reqs), want, replace=False))]


class _Clock:
    """Seconds spent in each step of the reference's pass (synchronised)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spent: Dict[str, float] = {}

    def __call__(self, name, fn, *args):
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        if self.cuda:
            torch.cuda.synchronize()
        self.spent[name] = self.spent.get(name, 0.0) + time.perf_counter() - t
        return out

    def __str__(self):
        return ", ".join(f"{k} {v:.2f}" for k, v in self.spent.items())


def _answer_numbers(served_s, served_ids, ref_at, ref_s, n_docs) -> Dict[str, float]:
    """score_gap, rank_gap and bad_ids of served answers [Q, k]."""
    served_s = torch.as_tensor(served_s, dtype=torch.float64)
    ids = torch.as_tensor(served_ids, dtype=torch.int64)
    ref_at = ref_at.to(torch.float64).cpu()
    ref_s = ref_s.to(torch.float64).cpu()
    valid = (ids >= 0) & (ids < n_docs)
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(ids.numel()).reshape(ids.shape)),
                     dim=1).values
    repeated = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    bad = int((~valid).sum()) + int(repeated.sum())
    scale = ref_s[:, :1].abs().clamp_min(1e-30)
    k = min(ids.shape[1], ref_s.shape[1])
    score_gap = torch.where(valid, (served_s - ref_at).abs() / scale, math.inf)
    rank_gap = torch.where(valid[:, :k], (ref_s[:, :k] - ref_at[:, :k]).clamp_min(0) / scale,
                           math.inf)
    if ids.shape[1] < ref_s.shape[1]:
        bad += int((ref_s.shape[1] - ids.shape[1]) * ids.shape[0])
    return {"score_gap": min(BIG, float(score_gap.max())),
            "rank_gap": min(BIG, float(rank_gap.max())), "bad_ids": bad}


def judge(cfg: dict, seed: int, device, weights, kind, ref_kind, index, pool: np.ndarray,
          sampled: Sequence) -> Dict[str, float]:
    """The numbers of the port's answers to ``sampled`` requests and its index."""
    binarizer = Binarizer(*weights, n_levels=cfg["n_levels"], device=device)
    q_ref, differ = [], 0
    for r in sampled:
        f = torch.from_numpy(pool[r.offset:r.offset + r.n_queries]).to(device)
        codes = binarizer.encode(f)
        differ += int((r.codes.to(device).to(torch.int8) != codes).any(-1).sum())
        q_ref.append(codes)
    q_ref = torch.cat(q_ref)
    served_ids = torch.from_numpy(np.concatenate([r.ids for r in sampled])).to(device).long()
    served_s = np.concatenate([r.scores for r in sampled])
    search = ref_kind.Search(cfg, q_ref)
    corpus = Corpus(cfg, seed, device)
    rows_differ = 0
    ref_at = torch.full(served_ids.shape, -math.inf, device=device)
    rows = torch.arange(served_ids.shape[0], device=device)[:, None].expand_as(served_ids)
    clock = _Clock(device)
    for c in range(corpus.n_chunks):
        s, e = corpus.bounds(c)
        f = clock("corpus", corpus.docs, c)
        codes = clock("encode", binarizer.encode, f)
        arrays = clock("index", ref_kind.index_arrays, cfg, codes)
        part = clock("port build", kind.build, cfg, codes, device)
        rows_differ += int(clock("compare", assemble.rows_differ, index, cfg["n_docs"], part,
                                 s, e - s, device).sum())
        del part
        scores = clock("search", search.add, s, arrays)
        m = (served_ids >= s) & (served_ids < e)
        ref_at[m] = scores[rows[m], served_ids[m] - s]
    ref_s, _, _ = search.result()
    print(f"[bench] reference pass seconds: {clock}", file=sys.stderr, flush=True)
    out = {"query_codes": differ / q_ref.shape[0], "index_rows": rows_differ / cfg["n_docs"]}
    out.update(_answer_numbers(served_s, served_ids.cpu(), ref_at, ref_s, cfg["n_docs"]))
    return out


def control(cfg: dict, seed: int, device, weights, kind, ref_kind, pool: np.ndarray,
            requests: Sequence[tuple]) -> Dict[str, float]:
    """The same numbers for the control: the reference encoding with TF32
    products put in the port's place (its corpus codes indexed by the
    port's build, as the port's own are), judged by the reference at
    float32. ``requests`` are (pool offset, queries) pairs."""
    binarizer = Binarizer(*weights, n_levels=cfg["n_levels"], device=device)
    q_ref, q_ctl, differ = [], [], 0
    for off, n in requests:
        f = torch.from_numpy(pool[off:off + n]).to(device)
        q_ref.append(binarizer.encode(f))
        q_ctl.append(binarizer.encode(f, tf32=True))
        differ += int((q_ref[-1] != q_ctl[-1]).any(-1).sum())
    q_ref, q_ctl = torch.cat(q_ref), torch.cat(q_ctl)
    search, ctl_search = ref_kind.Search(cfg, q_ref), ref_kind.Search(cfg, q_ctl)
    corpus = Corpus(cfg, seed, device)
    rows_differ = 0
    for c in range(corpus.n_chunks):
        s, e = corpus.bounds(c)
        f = corpus.docs(c)
        codes, ctl_codes = binarizer.encode(f), binarizer.encode(f, tf32=True)
        arrays = ref_kind.index_arrays(cfg, codes)
        rows_differ += int(assemble.rows_differ(kind.build(cfg, ctl_codes, device), e - s,
                                                kind.build(cfg, codes, device), 0, e - s,
                                                device).sum())
        ctl_search.add(s, ref_kind.index_arrays(cfg, ctl_codes), carried=[search.add(s, arrays)])
    ref_s, _, _ = search.result()
    ctl_s, ctl_ids, (ref_at,) = ctl_search.result()
    out = {"query_codes": differ / q_ref.shape[0], "index_rows": rows_differ / cfg["n_docs"]}
    out.update(_answer_numbers(ctl_s.cpu(), ctl_ids.cpu(), ref_at, ref_s, cfg["n_docs"]))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (and every limited number present)."""
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())
