"""Launch-shape defaults of the SDC kernels (ports ``repro/kernels/sdc/defaults.py``).

``BlockPlan`` is the autotuner's unit: a kernel kind and its
``(block_q, block_n)``. The values are the reference's, kept so that a
plan tuned for one package reads the same in the other. The CUDA
``sdc_topk`` sizes its own grid from the card (one wave of blocks, each
scanning one slice of the corpus for a chunk of up to 16 queries held in
shared memory), so on this port a scan plan shapes nothing and changes
no score. The reference's
TPU roofline constants are not carried over.
"""

from __future__ import annotations

from typing import NamedTuple


class BlockPlan(NamedTuple):
    """Launch shapes for one kernel kind, plus where they came from."""

    kind: str
    block_q: int
    block_n: int
    source: str = "default"

    def blocks(self) -> tuple[int, int]:
        return (self.block_q, self.block_n)


BLOCK_Q = 128
BLOCK_N = 512

# FlatSDC's per-call query tile in the reference (one f32 sublane).
FLAT_BLOCK_Q = 8

RERANK_GROUP = 1

DEFAULT_PLANS = {
    "scan": BlockPlan("scan", BLOCK_Q, BLOCK_N, "default"),
    "gather": BlockPlan("gather", 1, 0, "default"),
    "rerank": BlockPlan("rerank", 1, RERANK_GROUP, "default"),
}

KERNEL_KINDS = tuple(DEFAULT_PLANS)


def default_plan(kind: str) -> BlockPlan:
    """The fallback plan for a kernel kind (KeyError on unknown kinds)."""
    if kind not in DEFAULT_PLANS:
        raise KeyError(f"unknown kernel kind {kind!r}; want one of {KERNEL_KINDS}")
    return DEFAULT_PLANS[kind]


def plan_for(block_plan, kind: str) -> BlockPlan | None:
    """Select the plan for one kernel kind from a ``BlockPlan`` or a
    ``{kind: BlockPlan}`` mapping; None when no plan targets ``kind``."""
    if block_plan is None:
        return None
    if isinstance(block_plan, BlockPlan):
        return block_plan if block_plan.kind == kind else None
    plan = block_plan.get(kind)
    if plan is not None and plan.kind != kind:
        raise ValueError(f"plan under key {kind!r} has kind {plan.kind!r}")
    return plan
