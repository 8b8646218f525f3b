"""Random binarizer weights from ``--seed``, as the ``(params, state)``
trees of float32 numpy arrays that both the port
(``binarize_lib.binarizer_from_numpy``) and the reference take.

Linear weights are He-scaled normals (``(d_in, d_out)``), biases small;
each hidden layer's running batch-norm statistics are set near the
variance its input gives that layer, so that the normalised units and
every level's signs are balanced, as in a trained binarizer. All values
are drawn on the device in two calls and split into leaves.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_port.corpus import _seed

_SALT_WEIGHTS = 3


def _mlp_shapes(d_in: int, h: int, d_out: int) -> List[Tuple[str, tuple]]:
    return [("in.w", (d_in, h)), ("in.b", (h,)), ("bn_scale", (h,)), ("bn_bias", (h,)),
            ("bn_mean", (h,)), ("bn_var", (h,)), ("out.w", (h, d_out)), ("out.b", (d_out,))]


def make(cfg: dict, seed: int, device) -> Tuple[Dict, Dict]:
    """``cfg`` keys: input_dim, code_dim, n_levels, hidden_dim (> 0)."""
    d, m, n, h = cfg["input_dim"], cfg["code_dim"], cfg["n_levels"], cfg["hidden_dim"]
    # (group, input dim, output dim, mean squared input norm): W's inputs are
    # unit rows or differences of two; R's are the partial codes b_t, whose
    # entries square to about 4/3 on average.
    mlps = [("W", d, m, 1.0)] + [("W", d, m, 2.0)] * (n - 1) + [("R", m, d, 4.0 * m / 3)] * (n - 1)
    sizes = [int(np.prod(s)) for _, di, do, _ in mlps for _, s in _mlp_shapes(di, h, do)]
    g = torch.Generator(device=device).manual_seed(_seed(seed, _SALT_WEIGHTS))
    normal = torch.randn(sum(sizes), generator=g, device=device).cpu().numpy()
    uniform = torch.rand(len(mlps) * h, generator=g, device=device).cpu().numpy()
    params: Dict = {"W": [], "R": []}
    state: Dict = {"W": [], "R": []}
    at = 0
    for i, (group, di, do, sq_norm) in enumerate(mlps):
        leaf = {}
        for name, shape in _mlp_shapes(di, h, do):
            size = int(np.prod(shape))
            leaf[name] = normal[at:at + size].reshape(shape)
            at += size
        var_h = sq_norm * 2.0 / di  # of a unit of x @ w_in
        var = var_h * (0.5 + uniform[i * h:(i + 1) * h])
        p = {"in": {"w": leaf["in.w"] * np.float32(np.sqrt(2.0 / di)),
                    "b": leaf["in.b"] * np.float32(0.01)},
             "bn_scale": 1.0 + np.float32(0.1) * leaf["bn_scale"],
             "bn_bias": np.float32(0.1) * leaf["bn_bias"],
             "out": {"w": leaf["out.w"] * np.float32(np.sqrt(2.0 / h)),
                     "b": leaf["out.b"] * np.float32(0.01)}}
        s = {"bn_mean": np.float32(0.1 * np.sqrt(var_h)) * leaf["bn_mean"],
             "bn_var": var.astype(np.float32)}
        params[group].append(_f32(p))
        state[group].append(_f32(s))
    return params, state


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree, dtype=np.float32)
