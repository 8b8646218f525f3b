"""Shared argument resolvers for the ``*_search_from_snapshot`` family
(ports ``repro/index/_snapshot.py``, with the same error messages).

Every index family exposes one rebuild-from-snapshot entry point with
the same convention::

    <kind>_search_from_snapshot(snapshot, *, k, packed, backend, ...,
                                rerank=None)

where ``snapshot`` is anything snapshot-shaped (duck-typed here as "has
``.codes`` and ``.n_levels``", so this package never imports the
serving layer). The two-argument form ``(codes, n_levels, *, ...)``
goes through the same resolver.

``rerank`` opts the entry point into bi-granular mode: a coarse scan
over the first ``coarse_levels`` residual levels generates ``k_coarse``
survivors, then the full-level codes rerank them to the final top-k.
``resolve_rerank_args`` is the one validator for that dict.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

_RERANK_KEYS = frozenset({"coarse_levels", "k_coarse"})


def resolve_snapshot_args(codes: Any,
                          n_levels: Optional[int]) -> Tuple[Any, int]:
    """Normalize ``(snapshot, None)`` / ``(codes, n_levels)`` to
    ``(codes, n_levels)``.

    A snapshot-shaped first argument (has ``.codes`` and ``.n_levels``)
    supplies both; passing an explicit ``n_levels`` alongside one that
    disagrees is an error (silently preferring either side would build
    an index that scores garbage). Raw codes require ``n_levels``; a
    snapshot whose ``.n_levels`` is ``None`` is rejected as the
    malformed snapshot it is, rather than blaming the caller for the
    missing argument.
    """
    snap_codes = getattr(codes, "codes", None)
    snap_levels = getattr(codes, "n_levels", None)
    if snap_codes is not None:
        if snap_levels is None:
            raise TypeError(
                f"snapshot {type(codes).__name__} carries .codes but its "
                ".n_levels is None — a snapshot must record the level "
                "count its codes were packed at"
            )
        if n_levels is not None and int(n_levels) != int(snap_levels):
            raise ValueError(
                f"n_levels={n_levels} disagrees with the snapshot's "
                f"n_levels={snap_levels}"
            )
        return snap_codes, int(snap_levels)
    if n_levels is None:
        raise TypeError(
            "n_levels is required when passing raw codes (or pass a "
            "CorpusSnapshot, which carries it)"
        )
    return codes, int(n_levels)


def resolve_rerank_args(
    rerank: Optional[Mapping[str, Any]],
    n_levels: int,
) -> Optional[Tuple[int, int]]:
    """Validate a ``rerank={"coarse_levels": c, "k_coarse": k'}`` dict.

    Returns ``(coarse_levels, k_coarse)``, or ``None`` when rerank is
    disabled. Constraints:

    - exactly the two keys above (typos would otherwise silently run
      single-tier);
    - ``1 <= coarse_levels < n_levels`` — equality would make the
      coarse tier the fine tier and the rerank a no-op;
    - ``k_coarse >= 1``. ``k_coarse < k`` is legal (the rerank pads the
      missing slots), as is ``k_coarse >= n_docs`` (the coarse scan
      clamps).
    """
    if rerank is None:
        return None
    keys = set(rerank)
    if keys != _RERANK_KEYS:
        raise ValueError(
            f"rerank must have exactly keys {sorted(_RERANK_KEYS)}, "
            f"got {sorted(keys)}"
        )
    coarse_levels = int(rerank["coarse_levels"])
    k_coarse = int(rerank["k_coarse"])
    if not 1 <= coarse_levels < int(n_levels):
        raise ValueError(
            f"rerank coarse_levels must be in [1, {int(n_levels) - 1}] "
            f"(strictly fewer levels than the fine tier's {n_levels}), "
            f"got {coarse_levels}"
        )
    if k_coarse < 1:
        raise ValueError(f"rerank k_coarse must be >= 1, got {k_coarse}")
    return coarse_levels, k_coarse


def split_effort(level: int, *, k: int, k_coarse: int) -> Tuple[int, int]:
    """Allocate an ``EffortKnob`` level across the bi-granular axes.

    Under pressure the cheapest recall to give up is rerank depth:
    halving ``k_coarse`` only narrows the fine gather (k' rows per
    query), whereas halving nprobe shrinks the candidate pool itself.
    So a degradation level first halves ``k_coarse`` (floored at ``k``
    — reranking fewer than k survivors can only lose results) and hands
    whatever is left of the level to the family's own knobs.

    Returns ``(k_coarse_effective, residual_level)`` where
    ``residual_level`` is the part of ``level`` not absorbed by
    ``k_coarse`` (to be applied to nprobe or the probe budget). Level 0
    is always ``(k_coarse, 0)`` — bit-identical to no knob.
    """
    level = max(0, int(level))
    kc_halvings = max(0, (k_coarse // max(k, 1)).bit_length() - 1)
    used = min(level, kc_halvings)
    return max(k, k_coarse >> used), level - used
