"""Launch-shape defaults of the SDC kernels (ports ``repro/kernels/sdc/defaults.py``).

``BlockPlan`` is the autotuner's unit: a kernel kind and its
``(block_q, block_n)``. The table's values are the reference's, kept so
that a plan read by one package reads the same in the other; they shape
nothing on this port. What a plan means here, by kind:

  * "scan" on the card: the CUDA ``sdc_topk``'s launch geometry, queries
    a scan block holds (1-16) and documents a corpus slice holds (a
    multiple of 256); concrete numbers, which ``launch/autotune.py``
    tunes and ``sdc.scan_geometry`` checks. Without a plan the kernel
    sizes its own grid (one wave of blocks of up to 16 queries). On CPU
    tensors a scan plan is inert.
  * "rerank": ``block_n`` is the survivors per list of the host-gathered
    rerank (``rerank.sdc_rerank_gathered``), on every device.
  * "gather": fixed geometry, never swept.

No plan changes a score or an id.

The roofline constants at the end price a step for
``launch/hillclimb.py``'s cost model under the reference's names. They
are an H100 SXM5 80GB's datasheet figures, not the reference's TPU ones:
bounds, which ``chip_smoke.py`` prints beside the card's measured rates.
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


# Roofline constants of one H100 SXM5 80GB (datasheet figures) for the
# hillclimb cost model, under the reference's names.
PEAK_FLOPS = 989.4e12  # dense bf16 tensor-core peak, FLOP/s (int8: twice that, ops/s)
HBM_BW = 3.35e12  # HBM3, bytes/s
# NVLink 4: 18 links, 25e9 bytes/s each way each. One card has no peer, so
# chip_smoke.py cannot measure this rate; it is the datasheet's.
LINK_BW = 25e9  # bytes/s per link, one direction
N_LINKS = 18
