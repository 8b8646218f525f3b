"""The JAX reference's sharding specs, cells and sharded LM runs, dumped to
JSON by one subprocess with 512 forced host devices (the device count
locks at JAX's first use, so the test process stays single-device).
Shared by ``tests/test_torch_sharding.py`` and ``tests/test_torch_cells.py``.

Specs are written as lists: ``None``, an axis name, or a list of axis
names per entry; tree keys are ``jax.tree_util.keystr`` parts joined with
"/", the keys of the port's ``train/checkpoint.flatten_tree``.
"""

import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_SCRIPT = r"""
import inspect, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs.registry import REGISTRY, all_cells, build_cell, get_arch
from repro.launch.mesh import make_host_mesh, make_production_mesh
from repro.models import gnn as gnn_lib, transformer as tf
from repro.models.recsys import dien, dlrm, mind, two_tower
from repro.parallel import sharding as shd

out_path, sections = sys.argv[1], set(sys.argv[2].split(","))
out = {}


def key(path):
    return "/".join(str(p) for p in path)


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


def specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {key(p): spec(s) for p, s in flat}


def host(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


MESHES = {"4x2": host((4, 2), ("data", "model")),
          "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
RECSYS = {"mind": (mind, ("item_table",), ()),
          "dlrm-rm2": (dlrm, (), ("tables",)),
          "two-tower-retrieval": (two_tower, ("user_table", "item_table"), ()),
          "dien": (dien, ("item_table", "cate_table"), ())}

if "specs" in sections:
    res = {}
    for mname, mesh in MESHES.items():
        m = res[mname] = {"dp_axes": list(shd.dp_axes(mesh))}
        for arch, entry in REGISTRY.items():
            cfg = entry.config
            if entry.family == "lm":
                m[f"lm_param/{arch}"] = specs(shd.lm_param_sharding(mesh, cfg))
                c = shd.lm_activation_constraint(mesh, cfg)
                m[f"lm_activation/{arch}"] = spec(jax.sharding.NamedSharding(
                    mesh, inspect.getclosurevars(c).nonlocals["spec"]))
                for cp in (False, True):
                    m[f"lm_cache/{arch}/{cp}"] = specs(
                        shd.lm_cache_sharding(mesh, cfg, context_parallel=cp))
            elif entry.family == "recsys":
                mod, tables, stacked = RECSYS[arch]
                shape = jax.eval_shape(lambda: mod.init_params(jax.random.PRNGKey(0), cfg))
                m[f"recsys_param/{arch}"] = specs(
                    shd.fill_param_sharding(mesh, shape, tables, stacked))
                m[f"replicate/{arch}"] = specs(shd.replicate_like(mesh, shape))
            else:
                shape = jax.eval_shape(lambda: gnn_lib.init_params(jax.random.PRNGKey(0), cfg))
                m[f"gnn_param/{arch}"] = specs(shd.gnn_param_sharding(mesh, shape))
        for name in ("lm_batch_sharding", "recsys_table_sharding", "recsys_batch_sharding",
                     "gnn_edge_sharding", "gnn_edge_feat_sharding", "gnn_node_sharding"):
            m[name] = spec(getattr(shd, name)(mesh))
        m["ns"] = spec(shd.ns(mesh, None, ("data",), "model"))
    out["specs"] = res

if "cells" in sections:
    res = {}
    for mname in ("16x16", "2x16x16"):
        mesh = MESHES[mname]
        for arch, shape in all_cells():
            cell = build_cell(arch, shape, mesh)
            flat, _ = jax.tree_util.tree_flatten_with_path(cell.abstract_args)
            res[f"{arch}|{shape}|{mname}"] = {
                "arch": cell.arch, "kind": cell.kind, "meta": cell.meta,
                "args": {key(p): [list(a.shape), str(a.dtype)] for p, a in flat},
                "shardings": specs(cell.in_shardings),
            }
    out["cells"] = res

if "runs" in sections:
    from repro.data import synthetic
    from repro.train import checkpoint as ck, optim, steps

    cfg = get_arch("llama3.2-1b").smoke_config
    params0 = tf.init_params(jax.random.PRNGKey(0), cfg)
    np.savez(out_path + ".params.npz", **{key(p): np.asarray(a) for p, a in
                                          jax.tree_util.tree_flatten_with_path(params0)[0]})
    batches = [synthetic.lm_batch(i, 8, 16, cfg.vocab) for i in range(4)]
    np.savez(out_path + ".batches.npz", **{f"{i}/{k}": np.asarray(v)
                                           for i, b in enumerate(batches) for k, v in b.items()})
    step = jax.jit(steps.lm_train_step(cfg, optim.AdamConfig(lr=1e-3)))
    mesh = make_host_mesh((4, 2), ("data", "model"))
    runs = {}
    # tests/test_engine_distributed.py::test_sharded_lm_train_step_runs
    params = jax.device_put(params0, shd.lm_param_sharding(mesh, cfg))
    opt = optim.adam_init(params)
    batch = jax.device_put(batches[0], {k: shd.lm_batch_sharding(mesh) for k in batches[0]})
    losses = []
    with mesh:
        for _ in range(2):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
    runs["sharded_step"] = losses
    # tests/test_fault_tolerance.py::test_elastic_resume_across_mesh_shapes
    params = jax.device_put(params0, shd.lm_param_sharding(mesh, cfg))
    opt = optim.adam_init(params)
    losses = []
    with mesh:
        for i in range(3):
            params, opt, metrics = step(params, opt, batches[i])
            losses.append(float(metrics["loss"]))
    ck.save(out_path + ".ckpt", 3, (params, opt))
    mesh2 = make_host_mesh((2, 2), ("data", "model"))
    like = (tf.init_params(jax.random.PRNGKey(0), cfg), optim.adam_init(params0))
    (params, opt), start = ck.restore(out_path + ".ckpt", like)
    params = jax.device_put(params, shd.lm_param_sharding(mesh2, cfg))
    with mesh2:
        params, opt, metrics = step(params, opt, batches[start])
    losses.append(float(metrics["loss"]))
    runs["elastic"] = {"losses": losses, "start": start}
    out["runs"] = runs

with open(out_path, "w") as f:
    json.dump(out, f)
"""


def run_reference(tmp_path, sections) -> dict:
    """The reference's dump of ``sections`` (specs, cells, runs) under ``tmp_path``."""
    out = os.path.join(str(tmp_path), "ref.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_SCRIPT), out,
                           ",".join(sections)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)
