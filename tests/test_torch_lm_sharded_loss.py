"""The LM train step's sharded loss and microbatches with values, over 8
gloo ranks, against the same step on one device.

  * The vocabulary-parallel loss (``spmd.class_nll``: each rank's row max
    and sum of ``exp`` over its own classes, all-reduced, the class dim
    never gathered): SMOKE llama3.2-1b's train step on a (4, 2) mesh, its
    256 classes split over the model axis, the sequence over it too.
  * A microbatch whose rows do not divide the data-parallel axes: SMOKE
    llama3.2-1b with 2 microbatches of 2 rows on a (2, 2, 2) mesh of
    ``("pod", "data", "model")``, where pod x data is 4: each microbatch
    is split over data and whole over pod (``steps._rows_like``,
    ``spmd.constrain(even=True)``), as llama3-405b's ``microbatch16``
    variant splits 16 rows on 2x16x16.

Held as ``tests/test_torch_hillclimb_lm.py`` holds its steps: the loss
within 1e-6 relative, each gradient leaf within 1e-5 of its largest
magnitude (float32 sums in another order).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 4, 32
# (name, mesh shape, mesh axes, microbatches)
CASES = [("vocab", (4, 2), ("data", "model"), 1), ("rows", (2, 2, 2), ("pod", "data", "model"), 2)]

_RANK = r"""
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs.archs import llama3_2_1b
from repro_torch.launch.mesh import LeafMesh
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as shd, spmd
from repro_torch.train import steps

torch.set_num_threads(1)
rank, addr, world_path, out_path, cases = sys.argv[1:6]
rank, cases = int(rank), json.loads(cases)
world = dict(np.load(world_path))
dist.init_process_group("gloo", init_method=addr, world_size=8, rank=rank)
res = {}
try:
    params = {"embed": torch.from_numpy(world["embed"]),
              "final_norm": torch.from_numpy(world["final_norm"]),
              "layers": {k[len("layers/"):]: torch.from_numpy(v) for k, v in world.items()
                         if k.startswith("layers/")}}
    batch = {"tokens": torch.from_numpy(world["tokens"]),
             "labels": torch.from_numpy(world["labels"])}
    for name, shape, axes, microbatches in cases:
        cfg = dataclasses.replace(llama3_2_1b.SMOKE, microbatches=microbatches, attn_chunk=8)
        mesh = LeafMesh(tuple(shape), tuple(axes), ["cpu"] * 8)

        def grads(p, b, constrain=None):
            loss_fn = lambda p, b: tf.lm_loss(p, b["tokens"], b["labels"], cfg,
                                              constrain=constrain)
            return steps._accumulate_grads(loss_fn, p, b, microbatches)

        if rank == 0:
            loss, g = grads(params, batch)
            res[f"{name}/loss/u"] = loss
            res.update({f"{name}/grad/{k}/u": v for k, v in g.items()})
        with spmd.bind(mesh):
            tok = shd.lm_batch_sharding(mesh)
            loss, g = spmd.run(lambda p, b: grads(p, b, shd.lm_activation_constraint(mesh, cfg)),
                               (params, batch),
                               (shd.lm_param_sharding(mesh, cfg), {"tokens": tok, "labels": tok}))
            res[f"{name}/loss/s"] = loss.full_tensor()
            res.update({f"{name}/grad/{k}/s": v.full_tensor() for k, v in g.items()})
    if rank == 0:
        np.savez(out_path, **{k: v.detach().numpy() for k, v in res.items()})
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """SMOKE llama3.2-1b's weights from a seeded generator, tokens and
    labels from a seeded numpy generator; the ranks' results (``/u``
    unsharded, ``/s`` sharded) of every case."""
    from repro_torch.configs.archs import llama3_2_1b
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import flatten_tree

    tmp = tmp_path_factory.mktemp("lm_loss")
    params = tf.init_params(llama3_2_1b.SMOKE, torch.Generator().manual_seed(0), device="cpu")
    world = {k.replace("['", "").replace("']", ""): v.numpy()
             for k, v in flatten_tree(params).items()}
    rng = np.random.default_rng(0)
    world["tokens"] = rng.integers(0, llama3_2_1b.SMOKE.vocab, (B, S)).astype(np.int32)
    world["labels"] = rng.integers(0, llama3_2_1b.SMOKE.vocab, (B, S)).astype(np.int32)
    world_path, out = str(tmp / "world.npz"), str(tmp / "rank0.npz")
    np.savez(world_path, **world)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), addr, world_path, out,
                               json.dumps(CASES)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(8)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_train_step_equals_unsharded(gloo, case):
    np.testing.assert_allclose(gloo[f"{case}/loss/s"], gloo[f"{case}/loss/u"], rtol=1e-6)
    names = sorted(k[len(f"{case}/grad/"):-2] for k in gloo
                   if k.startswith(f"{case}/grad/") and k.endswith("/u"))
    assert len(names) == 11  # embed, final norm and the 9 stacked layer leaves
    for name in names:
        got, want = gloo[f"{case}/grad/{name}/s"], gloo[f"{case}/grad/{name}/u"]
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_uneven_microbatch_is_split_over_data():
    """2 rows over pod x data = 4: the rows keep the data axis's split and
    are whole over pod, and the activations' constraint does the same."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import spmd

    class Mesh:  # a DeviceMesh's sizes: pod 2, data 2, model 2
        ndim = 3

        @staticmethod
        def size(i):
            return 2

    places = [Shard(0), Shard(0), Shard(1)]
    assert spmd.evenly((2, 32), places, Mesh) == [Replicate(), Shard(0), Shard(1)]
    assert spmd.evenly((4, 32), places, Mesh) == places
    assert spmd.evenly((1, 32), places, Mesh) == [Replicate(), Replicate(), Shard(1)]
