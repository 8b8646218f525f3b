"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload web-flat.q64-c8 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout. Needs a CUDA card (it never falls back
to the CPU) and the port under ``src/``. Progress, the card's name, power
limit, draw and clocks, the index's size, the requests attempted and failed,
and, last, every number the check compared beside its limit go to
standard error; the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` also ``breakdown``, and ``checks``.
"""

import time

T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# Caches of the CUDA toolchain stay inside the checkout, at fixed paths, set
# before anything is compiled: also for a kernel kind the port does not use yet.
os.environ.setdefault("CUDA_CACHE_PATH", str(CHECKOUT / "build" / "bench_port" / "cuda_cache"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "build" / "bench_port" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(CHECKOUT / "build" / "bench_port" / "torch_extensions"))
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
HANG_S = 340


def loaded_forbidden(modules=None) -> list:
    """Top-level names among ``modules`` (default: the loaded modules) that
    belong to JAX or the JAX package (whole names: ``repro_torch`` is not
    ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # A run that has not ended by then prints every thread's stack and exits.
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    import torch

    from bench_port import cell, spec

    bench = spec.benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell.log(f"card: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
             f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START, bench=bench)
    cell.log(f"metrics: {json.dumps(result['metrics'])}")
    found = loaded_forbidden()
    if found:
        print(f"[bench] loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"[check] correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
