"""Small sizes of the benchmark's configurations, for CPU tests."""

import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_port import spec  # noqa: E402

CELLS = ("web-flat.q64-c8", "video-bigr.q64-c8")


def overrides(cfg: dict) -> dict:
    """A corpus of 6,000 documents in chunks of 1,500 and a pool of 256."""
    out = {"n_docs": 6000, "chunk": 1500, "corpus": dict(cfg["corpus"], query_pool=256)}
    if cfg["index"] == "bigranular":
        out["k_coarse"] = 40
    return out


def tiny_config(cell: str):
    bench = spec.benchmark()
    w = spec.workload(bench, cell)
    cfg = spec.config(bench, w["config"])
    return {**cfg, **overrides(cfg)}, spec.traffic(w["traffic"])
