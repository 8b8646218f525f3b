"""Neighbor sampler for sampled GNN training (GraphSAGE-style fanout;
ports ``repro/models/sampler.py`` verbatim: numpy on the host, so the
same ``np.random.Generator`` state gives the same subgraph bit for bit).

Host-side (numpy) — sampling is data-pipeline work, the device step only
sees padded, static-shape subgraphs. Supports multi-hop fanout (e.g. the
``minibatch_lg`` shape: batch_nodes=1024, fanout 15-10) over a CSR
adjacency, with deterministic seeding per step for reproducible restarts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @staticmethod
    def from_edges(senders: np.ndarray, receivers: np.ndarray, n_nodes: int) -> "CSRGraph":
        order = np.argsort(senders, kind="stable")
        s, r = senders[order], receivers[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, s + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRGraph(indptr=indptr, indices=r.astype(np.int64))


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: List[int],
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Multi-hop uniform neighbor sampling.

    Returns (nodes, senders, receivers, edge_mask, seed_positions) where
    senders/receivers index into ``nodes`` (relabelled local ids), arrays are
    padded to the static maximum (len(seeds) * prod(cumulative fanout)).
    """
    layers = [np.unique(seeds)]
    edges_s: List[np.ndarray] = []
    edges_r: List[np.ndarray] = []
    frontier = layers[0]
    for f in fanouts:
        s_list, r_list = [], []
        for node in frontier:
            lo, hi = graph.indptr[node], graph.indptr[node + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = rng.choice(deg, size=take, replace=False)
            nbrs = graph.indices[lo + picks]
            s_list.append(nbrs)
            r_list.append(np.full(take, node, np.int64))
        if s_list:
            s = np.concatenate(s_list)
            r = np.concatenate(r_list)
        else:
            s = np.zeros(0, np.int64)
            r = np.zeros(0, np.int64)
        edges_s.append(s)
        edges_r.append(r)
        frontier = np.unique(s)
        layers.append(frontier)

    nodes = np.unique(np.concatenate(layers))
    relabel = -np.ones(graph.n_nodes, np.int64)
    relabel[nodes] = np.arange(len(nodes))

    all_s = relabel[np.concatenate(edges_s)] if edges_s else np.zeros(0, np.int64)
    all_r = relabel[np.concatenate(edges_r)] if edges_r else np.zeros(0, np.int64)

    # static-size padding
    max_edges = max(max_sampled_edges(len(seeds), fanouts), len(all_s))
    pad = max_edges - len(all_s)
    mask = np.concatenate([np.ones(len(all_s), bool), np.zeros(pad, bool)])
    all_s = np.concatenate([all_s, np.zeros(pad, np.int64)])
    all_r = np.concatenate([all_r, np.zeros(pad, np.int64)])
    return nodes, all_s.astype(np.int32), all_r.astype(np.int32), mask, relabel[seeds]


def max_sampled_edges(batch_nodes: int, fanouts: List[int]) -> int:
    """Static upper bound on sampled edge count for shape planning."""
    total, frontier = 0, batch_nodes
    for f in fanouts:
        total += frontier * f
        frontier = frontier * f
    return total
