"""The control of the check: the reference put in the port's place with
TF32 products in its encode (the precision below the float32 that the
configurations state), judged by the float32 reference exactly as a run
judges the port. It has to come out as not correct.

    python3 bench_port/control.py --workload web-flat.q64-c8 --seeds 11 12 13

runs it at the cell's own size, on the card, for each seed: the same
corpus, weights, pool and number of sampled queries (in requests of the
cell's size) as a run of that seed. It prints each number beside the
configuration's limit, one JSON line a seed. The benchmark's own runs do
not run it.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def control_numbers(cfg: dict, traffic: dict, seed: int, device) -> dict:
    import numpy as np

    from bench_port import check, spec, weights as weights_lib
    from bench_port.corpus import Corpus, _seed

    corpus = Corpus(cfg, seed, device)
    for c in range(corpus.n_chunks):
        corpus.collect(c, corpus.raw(c))
    pool = corpus.queries()
    q = traffic["queries_per_request"]
    n_req = math.ceil(traffic["check_queries"] / q)
    rng = np.random.default_rng(_seed(seed, 5))
    offsets = rng.choice(pool.shape[0] // q, n_req, replace=False) * q
    return check.control(cfg, seed, device, weights_lib.make(cfg, seed, device),
                         spec.index_kind(cfg["index"]), spec.reference_kind(cfg["index"]), pool,
                         [(int(o), q) for o in sorted(offsets)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's control, at a cell's size")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from bench_port import check, spec

    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    cfg, traffic = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = control_numbers(cfg, traffic, seed, "cuda")
        failed = sorted(k for k, v in numbers.items() if v > cfg["limits"].get(k, math.inf))
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "limits": cfg["limits"], "fails": failed,
                          "correct": check.verdict(numbers, cfg["limits"]),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
