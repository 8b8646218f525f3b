#!/usr/bin/env python3
"""The port's three examples at their defaults, each quality figure beside
the JAX reference's figure at the same key.

    PYTHONPATH=src python tools/example_figures.py [--device cuda|cpu]

Runs ``examples/{train_two_tower_e2e,quickstart,compat_upgrade}_torch.py``
with their default arguments on ``--device`` (the card unless ``cpu`` is
asked for) and prints one line a figure: the port's value, the
reference's at key 0 (``REF_ZOO_FIGURES`` in ``chip_smoke.py``, from
``reference_figures/zoo_examples.py``) and the gap, then the largest gap.
The examples seed their models as the reference's do (``prng.key``), so
on the CPU the gap measures how far the port's training arithmetic
carries a figure from the reference's; ``chip_smoke.py`` phase 11 holds
the card's figures within ``KEY0_MARGIN`` of the reference's.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the reference's figures; imports nothing heavy)

# each example's outputs, by the figure names chip_smoke.py holds
FIGURES = {
    "train_two_tower_e2e_torch": {"tt_group_float": "group_float", "tt_group_bebr": "group_bebr",
                                  "tt_cover": "cover"},
    "quickstart_torch": {"qs_recall_float": "recall_float", "qs_recall_bebr": "recall_bebr"},
    "compat_upgrade_torch": {"bc_old_old": "old_old", "bc_naive": "naive",
                             "bc_compat": "compat", "bc_mixed_v1": "mixed_v1",
                             "bc_mixed_v2": "mixed_v2"},
}


def figures(device: str) -> dict:
    """{figure: the port's value} from the three examples at their defaults."""
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")
                                     if os.path.isdir(os.path.join(ROOT, "build")) else None) as d:
        for example, names in FIGURES.items():
            argv = ["--device", device]
            if example.startswith("train_two_tower"):
                argv += ["--ckpt", os.path.join(d, "e2e")]
            res = chip_smoke._load_example(example).main(argv)
            out.update({fig: float(res[key]) for fig, key in names.items()})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    got = figures(args.device)
    worst = 0.0
    for fig, v in got.items():
        ref = chip_smoke.REF_ZOO_FIGURES[fig][0]
        worst = max(worst, abs(v - ref))
        print(f"[figures] {fig}: port {v:.4f}, reference key 0 {ref}, gap {abs(v - ref):.4f}")
    print(f"[figures] largest gap on {args.device}: {worst:.4f}")


if __name__ == "__main__":
    main()
