#!/usr/bin/env python3
"""Where a dry-run cell's per-device FLOPs, wire and peak come from.

    PYTHONPATH=src python tools/cell_attribution.py ARCH SHAPE [--layers 2] [--multi-pod] \
        [--top 20]

Builds the cell of a registry arch id and one of its shapes
(``configs/registry.build_cell``; an LM cell at ``--layers`` layers,
widths unchanged, ``--layers 0`` keeping the config's full depth), or a
variant of ``launch/hillclimb.VARIANTS`` (ARCH a hillclimb cell such as
``gnn_ogb``, SHAPE its variant), on 16x16 (``--multi-pod``: 2x16x16) and
counts its sharded step as ``launch/hillclimb._measure`` does, on the meta
device over a fake process group (no card), with three tallies added:

  * FLOPs by the model's line that ran them (the innermost frame of a
    model file: ``models/transformer.py``, ``models/gnn.py``,
    ``models/recsys/*.py``, ``train/steps.py`` or ``launch/hillclimb.py``,
    with the ``parallel/spmd.py`` line under it; a backward operator
    counts under ``steps.py``'s call of the backward);
  * wire bytes by that line and the collective's kind;
  * at the peak, the live bytes by the line that allocated them (the
    step's arguments under ``hillclimb._measure``'s line, those it reads and
    those it does not alike: the record's peak leaves the unread ones out).

Each figure is rank 0's, beside the whole step's FLOPs over the device
count, 256 or 512 (the share; not computed for a hillclimb variant written
under ``shard_map``). The signature memo of ``launch/hlo_cost`` is off
while it runs, so every operator is seen; the totals equal the record's.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys
import traceback

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.configs import cells as cells_mod  # noqa: E402
from repro_torch.configs.registry import build_cell, get_arch  # noqa: E402
from repro_torch.launch import hillclimb as hc  # noqa: E402
from repro_torch.launch import hlo_cost  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402

MODEL_FILES = ("models/transformer.py", "models/gnn.py", "train/steps.py",
               "launch/hillclimb.py")


def _is_model_file(path: str) -> bool:
    path = path.replace(os.sep, "/")
    return "repro_torch/" in path and (path.endswith(MODEL_FILES)
                                       or "/models/recsys/" in path)


def _site() -> str:
    """The innermost model line on the stack, and the spmd line under it."""
    stack = traceback.extract_stack()
    model = [f for f in stack if _is_model_file(f.filename)]
    inner = [f for f in stack if os.path.basename(f.filename) == "spmd.py"]
    where = f"{os.path.basename(model[-1].filename)}:{model[-1].lineno}" if model else "?"
    return where + (f" (spmd.py:{inner[-1].lineno})" if inner else "")


class _Tally:
    """The three tallies, filled by the patches ``tallied`` installs."""

    def __init__(self):
        self.flops = collections.Counter()
        self.wire = collections.Counter()
        self.born = {}
        self.at_peak = {}
        self.peak = 0


def _patched(tally: _Tally):
    count, track, add = hlo_cost._Counter._count, hlo_cost._Counter.track, spmd.CollectiveLog.add

    def counted(self, func, args, kwargs, out):
        before = self.flops
        count(self, func, args, kwargs, out)
        if self.flops != before and isinstance(self, hlo_cost._ShardedCounter):
            tally.flops[f"{_site()} {func._overloadpacket.__name__}"] += self.flops - before

    def tracked(self, t):
        key = id(t.untyped_storage())
        new = key not in self._alive
        track(self, t)
        if new:
            tally.born[key] = _site()
        if isinstance(self, hlo_cost._ShardedCounter) and self.live > tally.peak:
            tally.peak = self.live
            by = collections.Counter()
            for k, (n, _) in self._alive.items():
                by[tally.born.get(k, "arguments")] += n
            tally.at_peak = dict(by)

    def added(self, kind, nbytes, g):
        if g > 1:
            tally.wire[f"{_site()} {kind}"] += self.mult * spmd.wire_bytes(kind, nbytes, g)
        add(self, kind, nbytes, g)

    return {(hlo_cost._Counter, "_count"): counted, (hlo_cost._Counter, "track"): tracked,
            (spmd.CollectiveLog, "add"): added,
            (hlo_cost._ShardedCounter, "_dtensor_call"):
                lambda self, func, args, kwargs: self._dtensor_run(func, args, kwargs)}


def _nonzero(collectives: dict) -> dict:
    return {k: f"{v:.4e}" for k, v in collectives.items() if v}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch", help="a registry arch id, or a hillclimb cell (gnn_ogb, ...)")
    ap.add_argument("shape", help="one of the arch's shapes, or the hillclimb cell's variant")
    ap.add_argument("--layers", type=int, default=2,
                    help="an LM cell's depth; 0 keeps the config's (full depth)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (512 devices) instead of 16x16")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    n = 512 if args.multi_pod else 256
    mesh = make_production_mesh(multi_pod=args.multi_pod, devices=["meta"] * n)
    mesh_name = hc.mesh_name(args.multi_pod)
    depth = ""
    if args.arch in hc.VARIANTS:
        if args.shape not in hc.VARIANTS[args.arch]:
            ap.error(f"{args.arch}'s variants are {sorted(hc.VARIANTS[args.arch])}")
        fn, shardings, abstract = hc.VARIANTS[args.arch][args.shape](mesh)
    else:
        entry = get_arch(args.arch)
        if args.shape not in entry.shapes:
            ap.error(f"{args.arch}'s shapes are {list(entry.shapes)}")
        if entry.family == "lm":
            cfg = entry.config
            if args.layers:
                cfg = dataclasses.replace(cfg, n_layers=args.layers)
            cell = cells_mod.lm_cell(cfg, args.shape, mesh)
            depth = f" at {cfg.n_layers} layers"
        else:
            cell = build_cell(args.arch, args.shape, mesh)
        fn, shardings, abstract = cell.fn, cell.in_shardings, cell.abstract_args
    tally = _Tally()
    saved = {k: getattr(*k) for k in _patched(tally)}
    for (owner, name), patch in _patched(tally).items():
        setattr(owner, name, patch)
    try:
        rec = hc._measure(fn, shardings, abstract, mesh)
    finally:
        for (owner, name), orig in saved.items():
            setattr(owner, name, orig)
    if args.arch in hc.VARIANTS:
        share = ""
    else:
        whole = hlo_cost.step_costs(fn, *abstract)["flops"] / n
        share = f" ({rec['flops'] / whole:.4f}x the share {whole:.6e})"
    print(f"{args.arch} {args.shape}{depth} on {mesh_name}: FLOPs a device {rec['flops']:.6e}"
          f"{share}, wire {rec['wire_bytes']:.4e} B {_nonzero(rec['collectives'])}, peak "
          f"{rec['peak_gib']:.3f} GiB, replicated {rec['replicated'] or 'none'}")
    total = sum(tally.flops.values()) or 1
    print("FLOPs by line:")
    for k, v in tally.flops.most_common(args.top):
        print(f"  {v:.4e} ({v / total:.3f})  {k}")
    print("wire by line (B a device):")
    for k, v in tally.wire.most_common(args.top):
        print(f"  {v:.4e}  {k}")
    print(f"live at the peak ({tally.peak / 2**30:.3f} GiB) by the line that allocated it:")
    for k, v in sorted(tally.at_peak.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {v / 2**30:8.3f} GiB  {k}")


if __name__ == "__main__":
    main()
