"""Persistent block-plan autotuner for the SDC kernels (ports
``repro/launch/autotune.py``).

On first use of a kernel signature ``(kind, code_dim, n_shard, packed,
k, backend)`` it sweeps a small grid of ``(block_q, block_n)`` plans,
times each on synthetic operands of the live shapes (plans never change
scores, only launch geometry, so random codes time like real ones), and
persists the winner in a digest-keyed cache file. ``backend`` is the
resolved "cuda" or "torch" (``kernels/sdc/ops.resolve_backend``).

What a plan means on this port, by kind:

  * "scan" on "cuda": the CUDA ``sdc_topk``'s launch geometry, concrete
    numbers: ``block_q`` queries a scan block holds (1-16) and
    ``block_n`` documents a corpus slice holds (a multiple of 256). The
    default plan is the geometry the kernel picks for itself at
    ``sample_q`` queries (``sdc.scan_geometry``) and leads the grid:
    queries per block in {the default's, 4, 8, 16} x one, two or four
    waves of blocks (``sdc.scan_candidates``). Sweep at the serving
    batch's query count: the default's slices depend on it.
  * "scan" on "torch": no kernel, so the reference's default plan comes
    back at once (source "inert-backend", the reference's "xla").
  * "rerank", on both backends: the survivors per list of the
    host-gathered rerank, groups (1, 8, 32) up to k, through
    ``rerank.sdc_rerank_gathered``.
  * "gather": fixed geometry, never swept (source "fixed-geometry"); nor
    is a card scan past the fused kernel (k > 4096 or a code dim above
    256: the unfused route, source "unfused-route").

The cache follows ``launch/binarizer_cache.py``: one
``tuneplan-<digest>.json`` a signature under ``--tune-cache`` /
``$REPRO_BEBR_CACHE`` / ``~/.cache/repro-bebr``, written atomically (tmp
+ rename) and validated on load: a corrupt or stale entry (unreadable
JSON, signature drift, blocks that are not ints or, for a card scan, not
a legal geometry) is re-tuned, never trusted. Replicas and later
launches that share a directory share one plan. The default plan is
always timed and kept unless a candidate is strictly faster, so the
persisted ``tuned_ms <= default_ms``. Times are the median of ``reps``
calls after one warm-up: CUDA events on the card, ``perf_counter`` on
the CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sdc import sdc as sdc_mod
from repro_torch.kernels.sdc.defaults import BlockPlan, default_plan
from repro_torch.kernels.sdc.ops import resolve_backend, sdc_search_backend
from repro_torch.kernels.sdc.rerank import sdc_rerank_gathered
from repro_torch.launch.binarizer_cache import CACHE_ENV, resolve_cache_dir

__all__ = [
    "CACHE_ENV",
    "TunedPlan",
    "candidate_grid",
    "plan_digest",
    "resolve_cache_dir",
    "tuned_block_plan",
]

_SCHEMA = 1


class TunedPlan(NamedTuple):
    """A block plan, plus where it came from.

    ``tuned`` is False when the plan was loaded from the cache (or the
    signature is not swept); mirrors
    ``binarizer_cache.BinarizerCheckpoint.trained``.
    """

    plan: BlockPlan
    digest: str
    path: str | None
    tuned: bool


def plan_digest(
    kind: str, *, code_dim: int, n_shard: int, packed: bool, k: int,
    backend: str,
) -> str:
    """Digest of everything that determines the winning plan (the
    reference's, so one signature has one digest in both packages)."""
    h = hashlib.sha1()
    h.update(str(("tuneplan", _SCHEMA)).encode())
    h.update(str((kind, code_dim, n_shard, bool(packed), k, backend)).encode())
    return h.hexdigest()[:20]


def candidate_grid(
    kind: str, *, code_dim: int, n_shard: int, packed: bool, k: int,
    backend: str = "torch", sample_q: int = 8, device="cuda",
) -> list[tuple[int, int]]:
    """The (block_q, block_n) sweep for a signature, default plan first.

    "cuda" scans: the card's geometries at ``sample_q`` queries
    (``sdc.scan_candidates``), each a legal launch, none launching the
    grid of another. Otherwise the reference's grid: rerank groups (1, 8,
    32) up to k; for a scan its sublane/lane-aligned blocks (inert here).
    """
    base = default_plan(kind)
    if kind == "gather":
        return [base.blocks()]
    if kind == "rerank":
        groups = [g for g in (1, 8, 32) if g <= max(1, k)]
        return [(base.block_q, g) for g in (groups or [1])]
    if backend == "cuda":
        return sdc_mod.scan_candidates(sample_q, n_shard, code_dim, packed, k,
                                       resolve_device(device))
    cands: list[tuple[int, int]] = [base.blocks()]
    for bq in (8, 32, 128):
        for bn in (256, 512, 1024):
            if (bq, bn) not in cands:
                cands.append((bq, bn))
    return cands


def _time_call(fn, *, reps: int, device: torch.device) -> float:
    """Median seconds of ``fn`` after one untimed warm-up: CUDA events
    around each call on the card, ``perf_counter`` on the CPU."""
    fn()
    samples = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def _sweep_operands(
    kind: str, *, code_dim: int, n_shard: int, packed: bool, k: int,
    sample_q: int, n_levels: int, device: torch.device, seed: int = 0,
):
    """Synthetic live-shape operands (values are irrelevant to timing):
    queries on ``device``; a scan's corpus there too, made by a seeded
    generator on it; a rerank's fine tier and survivors in host memory,
    numpy draws as in the reference."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hi = 2 ** n_levels
    q = torch.randint(0, hi, (sample_q, code_dim), generator=gen, device=device,
                      dtype=torch.int8)
    if kind == "rerank":
        rng = np.random.default_rng(seed)
        if packed:
            fine = rng.integers(0, 256, size=(n_shard, code_dim // 2), dtype=np.uint8)
        else:
            fine = rng.integers(0, hi, size=(n_shard, code_dim), dtype=np.int8)
        fine_inv = rng.uniform(0.5, 1.0, size=n_shard).astype(np.float32)
        cand_rng = np.random.default_rng(1)
        cand = np.stack([cand_rng.choice(n_shard, size=min(k, n_shard), replace=False)
                         for _ in range(sample_q)]).astype(np.int32)
        return q, fine, fine_inv, cand
    if packed:
        d = torch.randint(0, 256, (n_shard, code_dim // 2), generator=gen, device=device,
                          dtype=torch.uint8)
    else:
        d = torch.randint(0, hi, (n_shard, code_dim), generator=gen, device=device,
                          dtype=torch.int8)
    inv = torch.rand(n_shard, generator=gen, device=device) * 0.5 + 0.5
    return q, d, inv


def _candidate_call(kind: str, blocks: tuple[int, int], operands, *, n_levels: int, k: int,
                    packed: bool, backend: str):
    """A zero-arg callable running one launch with the given blocks."""
    if kind == "rerank":
        q, fine, fine_inv, cand = operands
        return lambda: sdc_rerank_gathered(
            q, fine, fine_inv, cand, n_levels=n_levels, k=min(k, fine.shape[0]),
            packed=packed, group=blocks[1], backend=backend,
        )
    q, d, inv = operands
    plan = BlockPlan(kind, blocks[0], blocks[1], "candidate")
    return lambda: sdc_search_backend(q, d, inv, n_levels=n_levels, k=k, backend=backend,
                                      packed=packed, block_plan=plan)


def _plan_path(root: str, digest: str) -> str:
    return os.path.join(root, f"tuneplan-{digest}.json")


def _save_plan(path: str, payload: dict) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _load_plan(path: str, kind: str, signature: dict, device) -> BlockPlan:
    """Load and validate a cached plan; any defect raises ValueError."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or payload.get("schema") != _SCHEMA:
        raise ValueError("tune-cache schema mismatch")
    if payload.get("signature") != signature:
        raise ValueError("tune-cache signature drift (stale entry)")
    bq, bn = payload.get("block_q"), payload.get("block_n")
    if not (isinstance(bq, int) and isinstance(bn, int) and not isinstance(bq, bool)
            and not isinstance(bn, bool) and bq >= 1 and bn >= 0):
        raise ValueError(f"tune-cache blocks corrupt: {(bq, bn)!r}")
    if kind == "scan" and signature["backend"] == "cuda":
        sdc_mod.check_scan_blocks((bq, bn), signature["n_shard"], signature["code_dim"],
                                  signature["packed"], signature["k"], device)
    if kind == "rerank" and bn < 1:
        raise ValueError(f"tune-cache rerank group {bn} < 1")
    return BlockPlan(kind, bq, bn, "cache")


def tuned_block_plan(
    kind: str,
    *,
    code_dim: int,
    n_shard: int,
    packed: bool = False,
    k: int = 10,
    n_levels: int = 4,
    backend: str = "auto",
    cache_dir: str | None = None,
    sample_q: int = 8,
    reps: int = 2,
    device="cuda",
) -> TunedPlan:
    """Tune (or reload) the block plan for one kernel signature on ``device``.

    Returns a ``TunedPlan``; ``plan`` is always safe to thread through
    the search paths (plans never change scores). ``tuned`` is True only
    when this call ran the sweep; a cache hit reloads the winner the
    first caller persisted, so all replicas launch with one plan. The
    payload keeps each candidate's blocks and median ms (and on the card
    the grid it launched, ``sdc_topk.last_geometry``), the default's and
    the winner's ms, and the sweep's seconds.
    """
    device = resolve_device(device)
    resolved = resolve_backend(backend, device)
    base = default_plan(kind)
    if resolved == "torch" and kind != "rerank":
        # No kernel on the plain path: nothing to sweep or cache.
        return TunedPlan(base._replace(source="inert-backend"), "", None, False)
    if kind == "gather":
        return TunedPlan(base._replace(source="fixed-geometry"), "", None, False)
    if kind == "scan" and (k > sdc_mod.K_MAX or code_dim > sdc_mod.KERNEL_DIMS[-1]):
        # The card's unfused route (sdc_scores + a sort) has no geometry.
        return TunedPlan(base._replace(source="unfused-route"), "", None, False)

    signature = {
        "kind": kind, "code_dim": int(code_dim), "n_shard": int(n_shard),
        "packed": bool(packed), "k": int(k), "backend": resolved,
    }
    digest = plan_digest(kind, code_dim=code_dim, n_shard=n_shard, packed=packed, k=k,
                         backend=resolved)
    root = resolve_cache_dir(cache_dir)
    path = _plan_path(root, digest)
    if os.path.exists(path):
        try:
            return TunedPlan(_load_plan(path, kind, signature, device), digest, path, False)
        except (OSError, ValueError, KeyError, TypeError):
            pass  # corrupt or stale: re-tune

    t_sweep = time.perf_counter()
    operands = _sweep_operands(kind, code_dim=code_dim, n_shard=n_shard, packed=packed, k=k,
                               sample_q=sample_q, n_levels=n_levels, device=device)
    grid = candidate_grid(kind, code_dim=code_dim, n_shard=n_shard, packed=packed, k=k,
                          backend=resolved, sample_q=sample_q, device=device)
    timed = []
    for blocks in grid:
        fn = _candidate_call(kind, blocks, operands, n_levels=n_levels, k=k, packed=packed,
                             backend=resolved)
        t = _time_call(fn, reps=reps, device=device)
        launched = None
        if kind == "scan":
            launched = list(sdc_mod.sdc_topk.last_geometry)
        timed.append({"block_q": blocks[0], "block_n": blocks[1], "ms": t * 1e3,
                      "launched": launched})
    default_t = timed[0]["ms"]
    # Strict improvement required to displace the default plan.
    best = min(timed, key=lambda c: c["ms"])
    if best["ms"] >= default_t:
        best = timed[0]

    plan = BlockPlan(kind, int(best["block_q"]), int(best["block_n"]), "tuned")
    os.makedirs(root, exist_ok=True)
    _save_plan(path, {
        "schema": _SCHEMA,
        "signature": signature,
        "block_q": plan.block_q,
        "block_n": plan.block_n,
        "default_blocks": list(grid[0]),
        "default_ms": default_t,
        "tuned_ms": best["ms"],
        "candidates": timed,
        "sample_q": int(sample_q),
        "sweep_s": time.perf_counter() - t_sweep,
    })
    return TunedPlan(plan, digest, path, True)
