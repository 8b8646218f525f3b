"""Load the reference's binarizer checkpoints (the loader half of
``repro/launch/binarizer_cache.py``).

A checkpoint is an ``np.savez`` archive of the flattened ``(params,
bn_state)`` pytree, leaves named ``leaf_000, leaf_001, ...`` in
``jax.tree_util.tree_flatten`` order: dictionaries by sorted key, lists
in order. For the recurrent binarizer that is

    params: [P,] R[0..n-2], W[0..n-1]    (each MLP: bn_bias, bn_scale,
                                          in.b, in.w, out.b, out.w;
                                          without a hidden layer: out.b, out.w)
    state:  R[0..n-2], W[0..n-1]          (each: bn_mean, bn_var; none
                                          without a hidden layer)

56 leaves for n_levels=4 with a hidden layer. Training, the digest and
the cache directory come with the training slice.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.binarize_lib import BinarizerConfig, RecurrentBinarizer, binarizer_from_numpy


def _mlp_leaf_shapes(d_in: int, d_hidden: int, d_out: int):
    if d_hidden <= 0:
        return [("out.b", (d_out,)), ("out.w", (d_in, d_out))]
    return [
        ("bn_bias", (d_hidden,)), ("bn_scale", (d_hidden,)),
        ("in.b", (d_hidden,)), ("in.w", (d_in, d_hidden)),
        ("out.b", (d_out,)), ("out.w", (d_hidden, d_out)),
    ]


def _state_leaf_shapes(d_hidden: int):
    if d_hidden <= 0:
        return []
    return [("bn_mean", (d_hidden,)), ("bn_var", (d_hidden,))]


def checkpoint_layout(cfg: BinarizerConfig) -> List[tuple]:
    """(tree, index, leaf name, shape) of every leaf, in archive order."""
    n, h, d, m = cfg.n_levels, cfg.hidden_dim, cfg.input_dim, cfg.code_dim
    out = []
    if cfg.input_map:
        out.append(("params", "P", 0, "P", (d, d)))
    for t in range(n - 1):
        out += [("params", "R", t, name, s) for name, s in _mlp_leaf_shapes(m, h, d)]
    for t in range(n):
        out += [("params", "W", t, name, s) for name, s in _mlp_leaf_shapes(d, h, m)]
    for t in range(n - 1):
        out += [("state", "R", t, name, s) for name, s in _state_leaf_shapes(h)]
    for t in range(n):
        out += [("state", "W", t, name, s) for name, s in _state_leaf_shapes(h)]
    return out


def load_checkpoint_numpy(path: str, cfg: BinarizerConfig):
    """The archive as the reference's ``(params, state)`` tree of numpy arrays."""
    layout = checkpoint_layout(cfg)
    n = cfg.n_levels
    params: Dict = {"W": [{} for _ in range(n)], "R": [{} for _ in range(n - 1)]}
    state: Dict = {"W": [{} for _ in range(n)], "R": [{} for _ in range(n - 1)]}
    with np.load(path) as z:
        if len(z.files) != len(layout):
            raise ValueError(
                f"{path}: {len(z.files)} leaves, expected {len(layout)} for {cfg}"
            )
        for i, (tree, group, t, name, shape) in enumerate(layout):
            leaf = z[f"leaf_{i:03d}"]
            if leaf.shape != shape:
                raise ValueError(f"{path}: leaf {i} ({group}[{t}].{name}) has shape "
                                 f"{leaf.shape}, expected {shape}")
            if group == "P":
                params["P"] = leaf
                continue
            node = (params if tree == "params" else state)[group][t]
            if "." in name:
                sub, key = name.split(".")
                node = node.setdefault(sub, {})
                name = key
            node[name] = leaf
    return params, state


def load_checkpoint(path: str, cfg: BinarizerConfig, device="cuda") -> RecurrentBinarizer:
    """Load a reference checkpoint into an eval-mode binarizer on ``device``."""
    params, state = load_checkpoint_numpy(path, cfg)
    return binarizer_from_numpy(params, state, cfg, device)
