"""Multi-pod dry run: every (arch x shape x mesh) cell on the meta device
(ports ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k [--multi-pod] [--both-meshes] [--all] \\
        [--out dryrun_torch_results.json]

The reference lowers and compiles each cell's step for 256 or 512 fake
host devices and reads XLA's memory and cost analyses. The port builds the
cell on ``make_production_mesh(devices=["meta"] * n)`` and runs its step
on the meta-device arguments twice: whole, as one device would run it,
under ``hlo_cost.step_costs``, and sharded, on DTensors over a fake
process group of n ranks, under ``hlo_cost.sharded_step_costs``: shapes
and dtypes flow through every operator, nothing is allocated and nothing
touches a card. The meta device and the fake group are the dry run's by
design, as the reference's fake host devices are its; they are not a fall
back to the CPU.

Per cell it records the reference's keys (``arch``, ``shape``, ``kind``,
``mesh``, ``n_devices``, ``ok``, ``memory``, ``cost``, ``collectives``,
``meta``), merged into ``--out`` as the reference merges:

  * ``memory.argument_bytes``: the bytes one leaf holds of the arguments,
    exact from the shardings (``parallel/sharding.tree_leaf_bytes``), and
    ``memory.peak_bytes_per_device``: the most bytes rank 0 had alive at
    once in the sharded step, its pieces of the arguments included;
  * ``memory.unsharded_*``: the step as one device would run it whole
    (arguments, peak of live bytes, and the peak less the arguments),
    not a per-device figure;
  * ``cost``: per device (the sharded step) ``flops_per_device`` and
    ``bytes_per_device``; for the whole step (unsharded) the FLOPs
    (products only, as the reference counts them), its eager bytes (no
    fusion) and the operators dispatched;
  * ``collectives``: per device, the wire bytes of each collective kind
    (``wire_bytes_per_device``, the reference's ring model) and their
    ``counts``, from the sharded step, and ``replicated``: operators whose
    sharding DTensor could not propagate, run on replicated operands.

The unsharded step runs once for a cell whose arguments have the same
shapes and dtypes on both meshes (all but meshgraphnet's, whose graph
pads to the mesh); the sharded step runs on each mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _signature(args) -> tuple:
    from repro_torch.train.checkpoint import flatten_tree

    return tuple((k, tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else (k, v)
                 for k, v in flatten_tree(args).items())


def argument_bytes(cell) -> int:
    """The bytes one leaf of ``cell``'s mesh holds of its arguments (host
    numbers hold none)."""
    from repro_torch.parallel.sharding import tree_leaf_bytes

    return sum(tree_leaf_bytes(a, s) for a, s in zip(cell.abstract_args, cell.in_shardings))


def run_cell(arch_id: str, shape_id: str, multi_pod: bool,
             costs_cache: Optional[Dict[Any, Dict[str, Any]]] = None) -> Dict[str, Any]:
    """The dry-run record of one cell. ``costs_cache`` (a dictionary kept
    across calls) reuses a step's costs for arguments of the same shapes."""
    from repro_torch.configs.registry import build_cell
    from repro_torch.launch.hlo_cost import sharded_step_costs, step_costs
    from repro_torch.launch.mesh import make_production_mesh

    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    cell = build_cell(arch_id, shape_id, mesh)
    key = (arch_id, shape_id, _signature(cell.abstract_args))
    t0 = time.perf_counter()
    costs = None if costs_cache is None else costs_cache.get(key)
    if costs is None:
        costs = step_costs(cell.fn, *cell.abstract_args)
        if costs_cache is not None:
            costs_cache[key] = costs
    sharded = sharded_step_costs(cell.fn, cell.abstract_args, cell.in_shardings, mesh)
    run_s = time.perf_counter() - t0
    arg_bytes = argument_bytes(cell)
    if sharded["argument_bytes"] != arg_bytes:
        raise AssertionError(f"the sharded step's pieces of the arguments take "
                             f"{sharded['argument_bytes']} bytes, the shardings say {arg_bytes}")
    return {
        "arch": arch_id,
        "shape": shape_id,
        "kind": cell.kind,
        "mesh": _mesh_name(multi_pod),
        "n_devices": n,
        "ok": True,
        "run_s": round(run_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "peak_bytes_per_device": sharded["peak_bytes"],
            "unsharded_argument_bytes": costs["unsharded_argument_bytes"],
            "unsharded_temp_bytes": costs["unsharded_peak_bytes"]
            - costs["unsharded_argument_bytes"],
            "unsharded_peak_bytes": costs["unsharded_peak_bytes"],
        },
        "cost": {
            "flops_per_device": sharded["flops"],
            "bytes_per_device": sharded["bytes"],
            "flops_per_step": costs["flops"],
            "eager_bytes_per_step": costs["bytes"],
            "ops": costs["ops"],
        },
        "collectives": {
            "wire_bytes_per_device": sharded["collectives"],
            "counts": sharded["counts"],
            "replicated": sharded["replicated"],
        },
        "meta": cell.meta,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_torch_results.json")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import all_cells

    if args.all:
        cells_list = list(all_cells())
    elif args.arch and args.shape:
        cells_list = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all required")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    # incremental: merge into an existing results file
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    costs_cache: Dict[Any, Dict[str, Any]] = {}
    for arch_id, shape_id in cells_list:
        for mp in meshes:
            key = f"{arch_id}|{shape_id}|{_mesh_name(mp)}"
            if results.get(key, {}).get("ok"):
                print(f"[skip] {key} (cached)")
                continue
            print(f"[run ] {key}", flush=True)
            try:
                res = run_cell(arch_id, shape_id, mp, costs_cache)
                gib = res["memory"]["argument_bytes"] / 2**30
                wire = sum(res["collectives"]["wire_bytes_per_device"].values())
                print(f"[ ok ] {key}: run={res['run_s']}s args={gib:.2f} GiB/leaf "
                      f"flops={res['cost']['flops_per_step']:.3e}/step "
                      f"{res['cost']['flops_per_device']:.3e}/device wire={wire:.3e} B/device",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                res = {
                    "arch": arch_id, "shape": shape_id, "mesh": _mesh_name(mp),
                    "ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:],
                }
                print(f"[FAIL] {key}: {res['error']}", flush=True)
            results[key] = res
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK -> {args.out}")
    return results


if __name__ == "__main__":
    main()
