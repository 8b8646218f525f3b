"""Graceful degradation of the serving tier (ports ``EffortKnob`` of
``repro/launch/proxy.py``; the query router comes with the serving tier).
"""

from __future__ import annotations

import threading


class EffortKnob:
    """Shared mutable search-effort level: 0 = full effort, each step up
    trades recall for latency.

    The index closures read ``knob.level`` per call
    (``ivf_search_from_snapshot(..., effort=knob)`` halves nprobe or the
    probe budget per level), and the router steps the same knob object
    down under pressure and back up when it clears. Bi-granular closures
    (``rerank=``) spend levels on a cheaper axis first: each level halves
    ``k_coarse`` (floored at k) and only the residual levels fall through
    to nprobe or the budget (``index._snapshot.split_effort``).
    Thread-safe; reads are a bare int load so the search path pays
    nothing.
    """

    def __init__(self, n_levels: int = 3):
        if n_levels < 1:
            raise ValueError(f"EffortKnob needs n_levels >= 1, got {n_levels}")
        self.max_level = n_levels - 1
        self._lock = threading.Lock()
        self._level = 0
        self.degrade_count = 0
        self.restore_count = 0

    @property
    def level(self) -> int:
        return self._level

    def degrade(self) -> bool:
        """Step effort down one level; False when already at the floor."""
        with self._lock:
            if self._level >= self.max_level:
                return False
            self._level += 1
            self.degrade_count += 1
            return True

    def restore(self) -> bool:
        """Step effort back up one level; False when already at full."""
        with self._lock:
            if self._level <= 0:
                return False
            self._level -= 1
            self.restore_count += 1
            return True

    def reset(self) -> None:
        with self._lock:
            self._level = 0
