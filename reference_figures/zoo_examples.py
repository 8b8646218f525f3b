#!/usr/bin/env python3
"""The JAX reference examples' quality figures, on the CPU: the figures
``chip_smoke.py`` phase 11 holds the port's examples to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python reference_figures/zoo_examples.py [--keys 6]

Runs ``examples/train_two_tower_e2e.py``, ``examples/quickstart.py`` and
``examples/compat_upgrade.py`` as they are, with their defaults (the
two-tower example's checkpoint in a fresh directory under ``build/``,
removed afterwards, so it trains its 400 steps and resumes nothing), and
reads the quality figures each prints. It does so ``--keys`` times: run
i offsets every ``jax.random.PRNGKey(s)`` the examples make to
``PRNGKey(s + 100 i)`` (run 0 is the examples as they are), which draws
other initial weights from the same data, the way the port's own
generator does. It prints one JSON line: each figure at run 0, and its
minimum, maximum and mean over the runs (the reference's own spread from
its initial weights alone). The figures:

  * two-tower e2e: top-10 in the user's taste group, float and BEBR, and
    the float top-10 covered by the BEBR top-100 (printed to 2 decimals);
  * quickstart: recall@10 of the float index and of the BEBR index;
  * compat_upgrade: recall@10 of (old q, old index), of new queries
    through phi_old, of new queries through the BC-trained phi_new on the
    old index, and of the mixed v1/v2 traffic across the live migration.

This script runs the reference only; it is not part of the PyTorch port.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import runpy
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# figure -> (example, regular expression over its output)
FIGURES = {
    "tt_group_float": ("train_two_tower_e2e", r"taste group: float=([\d.]+)"),
    "tt_group_bebr": ("train_two_tower_e2e", r"taste group: float=[\d.]+ BEBR=([\d.]+)"),
    "tt_cover": ("train_two_tower_e2e", r"covered by BEBR top-100: ([\d.]+)"),
    "qs_recall_float": ("quickstart", r"float index:.*recall@10=([\d.]+)"),
    "qs_recall_bebr": ("quickstart", r"BEBR  index:.*recall@10=([\d.]+)"),
    "bc_old_old": ("compat_upgrade", r"\(old q, old index\) recall@10 = ([\d.]+)"),
    "bc_naive": ("compat_upgrade", r"through phi_old, old index\) recall@10 = ([\d.]+)"),
    "bc_compat": ("compat_upgrade", r"zero backfill\) recall@10 = ([\d.]+)"),
    "bc_mixed_v1": ("compat_upgrade", r"migration: recall@10 v1=([\d.]+)"),
    "bc_mixed_v2": ("compat_upgrade", r"migration: recall@10 v1=[\d.]+ v2=([\d.]+)"),
}


def _run(example: str, argv) -> str:
    """Run ``examples/<example>.py`` as ``__main__`` with ``argv``; its stdout."""
    path = os.path.join(ROOT, "examples", f"{example}.py")
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


def _figures(ckpt: str, seconds: dict) -> dict:
    """One run of the three examples: {figure: value}."""
    outputs = {}
    for example, argv in (("train_two_tower_e2e", ["--ckpt", ckpt]), ("quickstart", []),
                          ("compat_upgrade", [])):
        t0 = time.perf_counter()
        outputs[example] = _run(example, argv)
        seconds.setdefault(example, []).append(round(time.perf_counter() - t0, 1))
        print(outputs[example], file=sys.stderr, end="")
    figures = {}
    for name, (example, pattern) in FIGURES.items():
        m = re.search(pattern, outputs[example])
        if m is None:
            raise RuntimeError(f"{example} printed no {name} ({pattern!r})")
        figures[name] = float(m.group(1))
    return figures


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", type=int, default=6)
    args = ap.parse_args()

    import jax

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="zoo_examples_ckpt_", dir=os.path.join(ROOT, "build"))
    key = jax.random.PRNGKey
    runs, seconds = [], {}
    try:
        for i in range(args.keys):
            jax.random.PRNGKey = lambda s, i=i: key(s + 100 * i)
            runs.append(_figures(os.path.join(ckpt, str(i)), seconds))
            print(f"[keys +{100 * i}] {json.dumps(runs[-1])}", file=sys.stderr, flush=True)
    finally:
        jax.random.PRNGKey = key
        shutil.rmtree(ckpt, ignore_errors=True)
    out = {name: {"default": runs[0][name], "min": min(r[name] for r in runs),
                  "max": max(r[name] for r in runs),
                  "mean": round(sum(r[name] for r in runs) / len(runs), 4)}
           for name in FIGURES}
    print(json.dumps({"keys": args.keys, "figures": out, "seconds": seconds}))


if __name__ == "__main__":
    main()
