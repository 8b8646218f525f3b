"""The dry-run cells' steps with values, sharded over 8 gloo ranks and whole
on one: the cells' own steps and layouts (``configs/cells.py``, the
``SMOKE`` configs at small batches, on a (4, 2) mesh of data and model
axes), the train steps' gradients (read where Adam takes them) and the
serve and retrieval steps' outputs, for ``tests/test_torch_*_dryrun_sharded.py``.

A case is ``(arch, shape)``. The batches shrink the cells' sizes (65,536
examples to 64, 512 to 16, 262,144 to 128, a million candidates to 1,000,
the 256 candidates a two-tower user scores to 16; a graph to 64 nodes and
256 edges) and are drawn from a seeded numpy generator; the parameters
from seeded torch generators, the same on every rank.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

_RANK = r"""
import contextlib, dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten
from repro_torch import prng
from repro_torch.configs.registry import get_arch
from repro_torch.launch.mesh import LeafMesh
from repro_torch.models import gnn as gnn_lib
from repro_torch.models.recsys import dien, dlrm, mind, two_tower
from repro_torch.models.recsys.embedding import tree_map
from repro_torch.parallel import spmd
from repro_torch.train import optim, steps

torch.set_num_threads(1)
rank, addr, out_path, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
SMALL = {65536: 64, 512: 16, 262144: 128, 1_000_000: 1000, 256: 16}
# the arch's config field that bounds each id of a batch
VOCAB = {"sparse_ids": "table_vocab", "pos_items": "item_vocab", "neg_items": "item_vocab",
         "cand_ids": "item_vocab", "hist_items": "item_vocab", "target_item": "item_vocab",
         "hist_cates": "cate_vocab", "target_cate": "cate_vocab"}
INIT = {"dlrm-rm2": lambda c, k: tree_map(torch.Tensor.detach,
                                          dlrm.init_dlrm(c, k, device="cpu").tree()),
        "two-tower-retrieval": lambda c, k: two_tower.init_params(c, k, device="cpu"),
        "mind": lambda c, k: mind.init_params(c, k, device="cpu"),
        "dien": lambda c, k: dien.init_params(c, k, device="cpu")}


def batch_for(arch, cfg, abstract, seed):
    rng = np.random.default_rng(seed)
    if arch == "meshgraphnet":
        n, e = 64, 256
        sizes = {abstract["node_feat"].shape[0]: n, abstract["senders"].shape[0]: e}
    out = {}
    for key, meta in abstract.items():
        shape = [sizes[d] if arch == "meshgraphnet" and i == 0 else SMALL.get(d, d)
                 for i, d in enumerate(meta.shape)]
        if key in ("senders", "receivers"):
            a = rng.integers(0, n, shape)
        elif key == "hist_ids":
            a = rng.integers(0, getattr(cfg, "user_vocab", getattr(cfg, "item_vocab", 0)), shape)
        elif key in VOCAB:
            a = rng.integers(0, getattr(cfg, VOCAB[key]), shape)
        elif key == "edge_mask":
            a = rng.random(shape) < 0.9
        elif key in ("hist_mask", "labels"):
            a = (rng.random(shape) < 0.8).astype(np.float32)
        else:
            a = rng.normal(size=shape).astype(np.float32)
        out[key] = torch.from_numpy(np.asarray(a)).to(meta.dtype)
    return out


def clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


GRADS = []
adam_update_ = optim.adam_update_


def keep_grads(grads, state, params, cfg, norm=None):  # Adam's input, Adam skipped
    GRADS.append({k: full(g).detach() for k, g in grads.items()})
    return state


dist.init_process_group("gloo", init_method=addr, world_size=8, rank=rank)
res = {}
try:
    mesh = LeafMesh((4, 2), ("data", "model"), ["cpu"] * 8)
    optim.adam_update_ = keep_grads
    for seed, (arch, shape) in enumerate(cases):
        entry = get_arch(arch)
        cfg = entry.smoke_config
        spec = entry.cell_builder(cfg, shape, mesh)
        if arch == "meshgraphnet":
            cfg = dataclasses.replace(cfg, d_node_in=spec.abstract_args[2]["node_feat"].shape[1],
                                      d_edge_in=8)
            params = gnn_lib.init_params(cfg, prng.key(seed, "cpu"), device="cpu")
        else:
            params = INIT[arch](cfg, prng.key(seed, "cpu"))
        batch = batch_for(arch, cfg, spec.abstract_args[-1], seed)
        name = f"{arch}|{shape}"
        for tag, run in (("u", lambda a: spec.fn(*a)),
                         ("s", lambda a: spmd.run(spec.fn, a, spec.in_shardings))):
            GRADS.clear()
            p = clone(params)  # a train step updates its parameters in place
            args = (p, steps.init_opt_state(p), batch) if spec.kind == "train" else (p, batch)
            with spmd.bind(mesh) if tag == "s" else contextlib.nullcontext():
                out = run(args)
            if spec.kind == "train":
                res.update({f"{name}|grad|{k}|{tag}": g for k, g in GRADS[0].items()})
                res[f"{name}|loss|{tag}"] = full(out[2]["loss"]).detach()
            else:
                for i, t in enumerate(tree_flatten(out)[0]):
                    res[f"{name}|out{i}|{tag}"] = full(t).detach()
finally:
    optim.adam_update_ = adam_update_
    dist.destroy_process_group()
if rank == 0:
    np.savez(out_path, **{k: v.to(torch.float64 if v.is_floating_point() else torch.int64).numpy()
                          for k, v in res.items()})
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def gloo_results(tmp_path, cases) -> dict:
    """Rank 0's results of ``cases`` over 8 gloo ranks: ``arch|shape|grad|
    <leaf>|u`` / ``|s`` (a train step's gradients, whole and sharded),
    ``arch|shape|loss|u`` / ``|s``, and ``arch|shape|out<i>|u`` / ``|s`` (the
    serve and retrieval steps' outputs)."""
    out = os.path.join(str(tmp_path), "rank0.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), addr, out,
                               json.dumps([list(c) for c in cases])], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(8)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return dict(np.load(out))


def close(got, want, rtol: float = 1e-5, scale=None) -> None:
    """Equal within ``rtol`` of the largest magnitude of ``want`` (or of
    ``scale``): float32 sums in another order, the sharded step reducing
    over ranks."""
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(scale, 1e-30))
