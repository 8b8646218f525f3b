#!/usr/bin/env python3
"""Count the ops one binarizer training step dispatches, by name.

    PYTHONPATH=src python tools/train_ops.py [--device cuda|cpu] [--warm 3]

Builds the serve CLI's training state (``serve.cli_train_config``: dim
256, code_dim 128, n_levels 4, hidden 512, queue 4,096, top_k 64) over
its 20,000-document corpus, takes ``--warm`` steps, then runs one
``train_step`` and one ``bc_train_step`` (from a warm copy of the online
encoder) under a ``TorchDispatchMode`` that counts every aten op
dispatched, and prints, per step, the total, the view-like ops (which
launch no kernel) and the most frequent names. It runs on the card, and raises without one,
unless ``--device cpu`` asks for the CPU: there the count predicts the
launches a step issues on the card, where ``chip_smoke.py`` phase 10
counts the launch calls themselves.
"""

from __future__ import annotations

import argparse
import collections
import copy
import os
import sys

from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.core import trainer as T  # noqa: E402
from repro_torch.data import synthetic as S  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

VIEW_OPS = ("view", "t.default", "transpose", "expand", "slice", "unsqueeze", "squeeze",
            "detach", "alias", "select", "permute", "as_strided")


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _report(tag: str, ops: collections.Counter) -> None:
    views = sum(n for name, n in ops.items() if any(v in name for v in VIEW_OPS))
    total = sum(ops.values())
    print(f"[ops] {tag}: {total} aten ops, {views} view-like, {total - views} others")
    print(f"[ops]   most frequent: " + ", ".join(f"{k} {n}" for k, n in ops.most_common(12)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = serve.cli_train_config()
    docs, _, _ = S.clustered_corpus(0, 20000, 64, 256)
    state = T.init_train_state(cfg, prng.key(0, device), device)
    gen = S.pair_batches(docs, 1, 256, device=device)
    for _ in range(args.warm):
        state, _ = T.train_step(state, *next(gen), cfg)
    a, p = next(gen)
    old = copy.deepcopy(state.model)
    bc = T.init_train_state(cfg, prng.key(7, device), device)
    bc = bc._replace(model=copy.deepcopy(old), m_model=copy.deepcopy(old))
    with _Count() as c:
        T.train_step(state, a, p, cfg)
    _report("train_step", c.ops)
    with _Count() as c:
        T.bc_train_step(bc, old, a, p, cfg)
    _report("bc_train_step", c.ops)


if __name__ == "__main__":
    main()
