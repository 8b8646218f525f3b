"""The op-cost counter and the dry run of the PyTorch port
(``repro_torch/launch/hlo_cost.py``, ``repro_torch/launch/dryrun.py``)
against the JAX reference's HLO walker (``repro/launch/hlo_cost.py``).

The reference compiles each case on one host device (so its per-device
count is the whole step's) in one subprocess, and ``hlo_costs`` reads the
FLOPs off the HLO, loop bodies times their trip counts. The port runs the
same function eagerly on meta tensors under ``step_costs``. They are equal
exactly on the reference tests' loop cases (``tests/test_pipeline_hlocost.py``:
scans of 1, 5 and 13 products, and 4 x 3 nested) and on one SMOKE cell per
model: LM dense and MoE train, two-tower retrieval, MIND and DIEN serve.
Two cells compute other products, each difference exact and explained:

  * dlrm-rm2 serve (ratio 0.851): the reference's forward forms the whole
    Gram matrix E E^T, F^2 dots of D per example; the port's interaction
    kernel computes only the F(F-1)/2 pairs it returns;
  * meshgraphnet train (ratio 1.133): the port's ``torch.utils.checkpoint``
    evaluates each layer's edge MLP again in the backward pass; XLA's
    compiled step evaluates it once (the node MLP's recompute is in both).

On the meta device the counter reuses a functional operator's result
signature; the same step on CPU tensors, with no reuse, gives the same
counts. The CLI writes the reference's record keys, per-leaf argument
bytes equal to the shardings' arithmetic, and merges into ``--out``.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import build_cell, get_arch  # noqa: E402
from repro_torch.launch.hlo_cost import step_costs  # noqa: E402
from repro_torch.launch.mesh import LeafMesh, make_production_mesh  # noqa: E402
from repro_torch.train.checkpoint import flatten_tree, unflatten_tree  # noqa: E402

torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.dirname(SRC)
LOOPS = {"scan1": (1, 1, 128), "scan5": (5, 1, 128), "scan13": (13, 1, 128),
         "nested4x3": (4, 3, 64)}
SMOKE = [("llama3.2-1b", "train_4k"), ("llama4-scout-17b-a16e", "train_4k"),
         ("meshgraphnet", "full_graph_sm"), ("dlrm-rm2", "serve_p99"),
         ("two-tower-retrieval", "retrieval_cand"), ("mind", "serve_p99"), ("dien", "serve_p99")]

_REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.registry import get_arch
from repro.launch.hlo_cost import hlo_costs

loops, smoke = json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {}
for name, (outer, inner, n) in loops.items():
    def f(x, w, outer=outer, inner=inner):
        def body(c, _):
            return jnp.tanh(c @ w), None

        def outer_body(c, _):
            y, _ = jax.lax.scan(body, c, None, length=inner)
            return y, None

        y, _ = jax.lax.scan(body if inner == 1 else outer_body, x, None, length=outer)
        return jnp.sum(y)

    x = jax.ShapeDtypeStruct((n, n), jnp.float32)
    out[name] = hlo_costs(jax.jit(f).lower(x, x).compile().as_text(), 1)["flops"]
mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
for arch, shape in smoke:
    entry = get_arch(arch)
    cell = entry.cell_builder(entry.smoke_config, shape, mesh)
    with mesh:
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings).lower(
            *cell.abstract_args).compile()
    out[f"{arch}|{shape}"] = hlo_costs(compiled.as_text(), 1)["flops"]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), str(out),
                           json.dumps(LOOPS), json.dumps(SMOKE)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _one_leaf():
    return LeafMesh((1, 1), ("data", "model"), ["meta"])


def _smoke_cell(arch, shape, mesh=None):
    entry = get_arch(arch)
    return entry.cell_builder(entry.smoke_config, shape, mesh or _one_leaf())


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_loop_flops_equal_the_reference(ref, name):
    outer, inner, n = LOOPS[name]

    def f(x, w):
        c = x
        for _ in range(outer * inner):
            c = torch.tanh(c @ w)
        return torch.sum(c)

    x = torch.empty((n, n), device="meta")
    got = step_costs(f, x, x)["flops"]
    assert got == ref[name] == outer * inner * 2 * n**3


def _dlrm_gram_excess(cfg, batch):
    """Products of the whole Gram matrix beyond the F(F-1)/2 pairs."""
    F, D = cfg.n_sparse + 1, cfg.embed_dim
    return 2 * batch * D * (F * F - F * (F - 1) // 2)


def _gnn_edge_recompute(cfg, n_edges):
    """Products of the edge MLPs' forward, once per layer."""
    h = cfg.d_hidden
    return cfg.n_layers * 2 * n_edges * (3 * h * h + cfg.mlp_layers * h * h)


@pytest.mark.parametrize("arch,shape", SMOKE)
def test_smoke_cell_flops_equal_the_reference(ref, arch, shape):
    cell = _smoke_cell(arch, shape)
    got = step_costs(cell.fn, *cell.abstract_args)["flops"]
    want = ref[f"{arch}|{shape}"]
    cfg = get_arch(arch).smoke_config
    if arch == "dlrm-rm2":
        want -= _dlrm_gram_excess(cfg, cell.meta["batch"])
        assert round(got / ref[f"{arch}|{shape}"], 3) == 0.851
    elif arch == "meshgraphnet":
        want += _gnn_edge_recompute(cfg, cell.meta["edges"])
        assert round(got / ref[f"{arch}|{shape}"], 3) == 1.133
    assert got == want


def _real(leaf, rng):
    """A CPU tensor in a valid range for ``leaf`` (ids small, masks 0/1)."""
    if leaf.dtype == torch.bool:
        return torch.from_numpy(rng.random(leaf.shape) < 0.8)
    if not leaf.dtype.is_floating_point:
        return torch.from_numpy(rng.integers(0, 8, leaf.shape)).to(leaf.dtype)
    return torch.from_numpy(rng.normal(size=leaf.shape) * 0.1).to(leaf.dtype)


@pytest.mark.parametrize("arch,shape", [("meshgraphnet", "molecule"), ("dien", "serve_p99"),
                                        ("dlrm-rm2", "serve_p99"), ("mind", "train_batch")])
def test_meta_counts_equal_the_cpu_counts(arch, shape):
    """The signature reuse on meta changes no count: the same step on CPU
    tensors (every operator run) counts the same."""
    cell = _smoke_cell(arch, shape)
    rng = np.random.default_rng(0)
    cpu_args = unflatten_tree(cell.abstract_args, [
        _real(v, rng) if isinstance(v, torch.Tensor) else v
        for v in flatten_tree(cell.abstract_args).values()])
    meta = step_costs(cell.fn, *cell.abstract_args)
    cpu = step_costs(cell.fn, *cpu_args)
    assert meta == cpu


def _leaf_bytes(shape, dtype, spec, mesh):
    """The bytes one leaf holds, from the spec: each sharded dim rounded up."""
    n = 1
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        n *= math.ceil(d / math.prod(mesh.axis_size(a) for a in axes))
    return n * dtype.itemsize


def test_cli_writes_the_reference_record(tmp_path):
    out = tmp_path / "dry.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
           "--shape", "train_4k", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1/1 cells OK" in proc.stdout
    rec = json.loads(out.read_text())["llama3.2-1b|train_4k|16x16"]
    assert {"arch", "shape", "kind", "mesh", "n_devices", "ok", "memory", "cost",
            "collectives", "meta"} <= set(rec)
    assert (rec["kind"], rec["mesh"], rec["n_devices"], rec["ok"]) == ("train", "16x16", 256, True)
    coll = rec["collectives"]
    assert set(coll["wire_bytes_per_device"]) == set(coll["counts"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"}
    # the data-parallel gradients are reduced and the FSDP weights gathered
    assert coll["counts"]["all-gather"] > 0 and coll["wire_bytes_per_device"]["all-gather"] > 0
    assert coll["counts"]["all-reduce"] + coll["counts"]["reduce-scatter"] > 0
    assert coll["replicated"] == {}
    assert 0 < rec["cost"]["flops_per_device"] < rec["cost"]["flops_per_step"]
    assert rec["memory"]["peak_bytes_per_device"] >= rec["memory"]["argument_bytes"]
    mesh = make_production_mesh(devices=["meta"] * 256)
    cell = build_cell("llama3.2-1b", "train_4k", mesh)
    want = 0
    for args, shs in zip(cell.abstract_args, cell.in_shardings):
        specs = flatten_tree(shs)
        for key, leaf in flatten_tree(args).items():
            if isinstance(leaf, torch.Tensor):
                want += _leaf_bytes(leaf.shape, leaf.dtype, specs[key].spec, mesh)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["meta"] == cell.meta and rec["meta"]["params"] == sum(
        t.numel() for t in flatten_tree(cell.abstract_args[0]).values())
    mem = rec["memory"]
    assert mem["unsharded_argument_bytes"] + mem["unsharded_temp_bytes"] == \
        mem["unsharded_peak_bytes"]
    assert rec["cost"]["flops_per_step"] > 6 * cell.meta["params"] * cell.meta["tokens_per_step"]
    again = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert again.returncode == 0 and "[skip] llama3.2-1b|train_4k|16x16 (cached)" in again.stdout


# ---------------------------------------------------------------------------
# sharded_step_costs: per-device counts of a step on DTensors.
# ---------------------------------------------------------------------------


def _mesh16():
    return LeafMesh((16, 16), ("data", "model"), ["meta"] * 256)


def test_sharded_product_counts_the_local_flops():
    """x [512, 4096] rows over data times w [4096, 8192] columns over model:
    each device multiplies [32, 4096] by [4096, 512], 2 M N K of the local
    shapes. DTensor's sharding propagation runs the product once on fake
    tensors of the global shapes (2 x 512 x 4096 x 8192); that is not
    counted, nor are its operators."""
    from repro_torch.launch.hlo_cost import sharded_step_costs
    from repro_torch.parallel.sharding import Sharding

    mesh = _mesh16()
    x = torch.empty((512, 4096), device="meta")
    w = torch.empty((4096, 8192), device="meta")
    got = sharded_step_costs(lambda a, b: a @ b, (x, w),
                             (Sharding(mesh, ("data", None)), Sharding(mesh, (None, "model"))),
                             mesh)
    assert got["flops"] == 2 * 32 * 4096 * 512
    assert got["ops"] == 1 and got["replicated"] == {}
    assert got["argument_bytes"] == (32 * 4096 + 4096 * 512) * 4
    assert got["bytes"] == (32 * 4096 + 4096 * 512 + 32 * 512) * 4
    assert sum(got["counts"].values()) == 0
    assert not torch.distributed.is_initialized()  # the fake group is gone


def test_peak_counts_the_arguments_the_step_reads():
    """An argument the step never reads stays out of the peak, as XLA prunes
    a jitted step's unused arguments; ``argument_bytes`` counts every one."""
    from repro_torch.launch.hlo_cost import sharded_step_costs
    from repro_torch.parallel.sharding import Sharding

    mesh = _mesh16()
    x = torch.empty((512, 4096), device="meta")
    unused = torch.empty((4096, 4096), device="meta")
    sh = (Sharding(mesh, ("data", None)), Sharding(mesh, ("model", None)))
    got = sharded_step_costs(lambda a, b: a * 2, (x, unused), sh, mesh)
    piece, other = 32 * 4096 * 4, 256 * 4096 * 4
    assert got["argument_bytes"] == piece + other
    assert got["peak_bytes"] == 2 * piece  # the piece read and the product's
    got = sharded_step_costs(lambda a, b: (a * 2, b + 1), (x, unused), sh, mesh)
    assert got["peak_bytes"] == 2 * piece + 2 * other


def test_all_to_all_is_counted_as_one_on_the_cpu_mesh():
    """Gloo has no all-to-all: on the CPU mesh type both the hand-written
    ``spmd.all_to_all`` and DTensor's shard-to-shard redistribution run as
    an all-gather and a chunk, and both are counted as the all-to-all they
    stand for (B (g - 1) / g of the operand's bytes)."""
    from repro_torch.launch.hlo_cost import sharded_step_costs
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import Sharding

    mesh = _mesh16()
    axes = ("data", "model")

    def exchange(x):
        return spmd.shard_map(lambda a: spmd.all_to_all(a, mesh, axes, 0, 0), mesh,
                              in_specs=(("data",),), out_specs=("data",))(x)

    got = sharded_step_costs(exchange, (torch.empty((256 * 256, 8), device="meta"),),
                             (Sharding(mesh, ("data",)),), mesh)
    assert got["counts"] == {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0,
                             "all-to-all": 1, "collective-permute": 0}
    assert got["collectives"]["all-to-all"] == 4096 * 8 * 4 * 255 / 256

    def reshard(x):
        return spmd.constrain(x, Sharding(mesh, (None, "model")))

    got = sharded_step_costs(reshard, (torch.empty((64, 64), device="meta"),),
                             (Sharding(mesh, ("model", None)),), mesh)
    assert got["counts"]["all-to-all"] == 1 and got["counts"]["all-gather"] == 0
    assert got["collectives"]["all-to-all"] == 4 * 64 * 4 * 15 / 16


def test_meta_microbatches_count_as_every_trip(monkeypatch):
    """Under a counter, a meta step's microbatch loop runs its first trip
    and its second, which counts for the rest (``steps._accumulate_grads``):
    the counts equal those of running every trip, whole and sharded."""
    import dataclasses

    from repro_torch.configs import cells as cells_mod
    from repro_torch.launch.hlo_cost import sharded_step_costs
    from repro_torch.train import steps

    mesh = LeafMesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = dataclasses.replace(get_arch("llama3.2-1b").smoke_config, microbatches=4)
    cell = cells_mod.lm_cell(cfg, "train_4k", mesh)
    trips = (step_costs(cell.fn, *cell.abstract_args),
             sharded_step_costs(cell.fn, cell.abstract_args, cell.in_shardings, mesh))
    monkeypatch.setattr(steps, "_loop_counter", lambda batch: None)
    every = (step_costs(cell.fn, *cell.abstract_args),
             sharded_step_costs(cell.fn, cell.abstract_args, cell.in_shardings, mesh))
    assert trips == every


@torch.library.custom_op("repro_torch_test::row_sums", mutates_args=())
def _row_sums(x: torch.Tensor) -> torch.Tensor:
    return x.sum(-1)


@_row_sums.register_fake
def _row_sums_fake(x):
    return x.new_empty(x.shape[:-1])


def test_operator_without_strategy_runs_replicated():
    """An operator DTensor has no sharding strategy for (here a custom one,
    as ``aten.diagonal_backward`` is in some torch releases) runs on each
    rank's whole copy of its gathered operands, and is listed."""
    from repro_torch.launch.hlo_cost import sharded_step_costs
    from repro_torch.parallel.sharding import Sharding

    mesh = LeafMesh((4, 4), ("data", "model"), ["meta"] * 16)
    got = sharded_step_costs(lambda x: _row_sums(x * 2.0), (torch.empty((64, 32), device="meta"),),
                             (Sharding(mesh, ("data", "model")),), mesh)
    assert got["replicated"] == {"repro_torch_test.row_sums.default": 1}
    # where it was called, and its operand's layout over (data, model)
    at = got["replicated_at"]["repro_torch_test.row_sums.default"]
    assert "test_torch_dryrun.py" in at and "_row_sums(x * 2.0)" in at
    from torch.distributed.tensor import Shard

    assert f"operands [((64, 32), ('{Shard(0)}', '{Shard(1)}'))]" in at
    # the [16, 8] piece gathered whole: over data and model, or at once
    assert got["counts"]["all-gather"] >= 1
    assert got["collectives"]["all-gather"] >= 64 * 32 * 4 * 15 / 16 - 16 * 8 * 4
