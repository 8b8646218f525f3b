"""The port's hillclimb driver (``repro_torch/launch/hillclimb.py``) and its
sharded execution (``repro_torch/parallel/spmd.py``) against the JAX
reference's (``repro/launch/hillclimb.py``).

The reference compiles each variant with GSPMD for 256 (or 512) forced
host devices, in one subprocess (``tests/_torch_hillclimb_ref.py``), and
reads per-device FLOPs and collective wire bytes off the HLO. The port
runs the same variant on DTensors over a fake process group of as many
ranks, on meta tensors, and counts rank 0's operators and collectives.

Equal to the reference: the per-device FLOPs of ``tt_retrieval``'s five
variants (the paper's cell; 18,064,384 for ``bebr_sdc`` and
``bebr_sdc_merge`` at 16x16) and of ``gnn_ogb``'s baseline, and
``bebr_sdc_merge``'s all-gather wire (12,000 B at 16x16, 24,800 B at
2x16x16, where its FLOPs are 10,064,384), the all-gather wire of the
other BEBR variants (the gathered scores) and of the baseline (its
gathered scores; where GSPMD gathers the million candidate ids, the port
gathers the item table's rows over the data axis, ``spmd.sharded_take``),
the two-tower lookups' all-reduce (the query bag's partial sums reduced
over the whole mesh in one collective: 65,280 B at 16x16) and
``gnn_ogb`` partitioned's all-gather and reduce-scatter (each layer's
checkpoint keeps its all-gather, ``spmd.checkpoint``). ``gnn_ogb``
partitioned's FLOPs a device are at most the reference's: the checkpoint
keeps the layer's products too, as the reference's compiled step does.

Each ``tt_retrieval`` variant, on 16x16 and on 2x16x16, is held by
``hold_record`` (nothing replicated, FLOPs and wire at most the
reference's, the peak at most twice its), and the reference's records of
them equal the committed ones that ``chip_smoke.py``'s phase 14 reads.

``bebr_sdc_merge`` also runs with values over an 8-process gloo group
(``LeafMesh((4, 2), ["cpu"] * 8)``) on the SMOKE two-tower with 0 and
negative inverse norms planted: ids exactly the reference's 8-device
``shard_map`` result and the port's unsharded ``bebr_sdc``.
"""

import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import (CELL_RECORDS, MULTI_POD_RECORDS, hold_record,  # noqa: E402
                                  ratios, run_reference)
from repro_torch.kernels.sdc import defaults  # noqa: E402
from repro_torch.launch import hillclimb as hc  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.dirname(SRC)
TT = ("baseline", "float_index", "bebr_sdc", "bebr_sdc_fullmesh", "bebr_sdc_merge")
WANTED = ([("tt_retrieval", v, mp) for mp in (False, True) for v in TT]
          + [("gnn_ogb", "baseline", False), ("gnn_ogb", "partitioned", False)])


def _key(cell, variant, multi_pod):
    return f"{cell}|{variant}|{hc.mesh_name(multi_pod)}"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("hillclimb"), [list(w) for w in WANTED])


@pytest.fixture(scope="module")
def port():
    torch.set_num_threads(1)
    return {_key(*w): hc.run_variant(*w) for w in WANTED}


def test_variant_names_equal_the_reference(ref):
    assert {c: sorted(v) for c, v in hc.VARIANTS.items()} == ref["variants"]


@pytest.mark.parametrize("variant", TT)
def test_tt_retrieval_flops_equal_the_reference(ref, port, variant):
    key = _key("tt_retrieval", variant, False)
    assert port[key]["ok"]
    assert port[key]["flops"] == ref[key]["flops"]


@pytest.mark.parametrize("multi_pod,wire,flops", [(False, 12_000, 18_064_384),
                                                  (True, 24_800, 10_064_384)])
def test_merge_gathers_k_results_a_leaf(ref, port, multi_pod, wire, flops):
    key = _key("tt_retrieval", "bebr_sdc_merge", multi_pod)
    for rec in (ref[key], port[key]):
        assert rec["collectives"]["all-gather"] == wire
        assert rec["flops"] == flops
    assert port[key]["counts"]["all-gather"] == 2  # the scores and the ids


@pytest.mark.parametrize("variant", ("baseline", "bebr_sdc", "bebr_sdc_fullmesh"))
def test_gathered_scores_equal_the_reference(ref, port, variant):
    """GSPMD and DTensor both gather the scores for the top k (3.75 MB of
    f32 a device for 1e6 candidates; the baseline gathers them twice, the
    candidate ids too): ``sdc_topk`` on DTensors scores the rows where they
    lie and gathers the scores, not the 64 MB of codes. The baseline's
    lookup of the million candidates: GSPMD gathers the ids whole (3.75 MB)
    and all-reduces the looked-up rows (2.04e9 B); the port gathers the
    item table's rows over the data axis (16 pieces of 8,192 rows of 256
    floats) and reduces the rank's own candidates' rows only."""
    key = _key("tt_retrieval", variant, False)
    got, want = port[key]["collectives"]["all-gather"], ref[key]["collectives"]["all-gather"]
    if variant == "baseline":
        got -= 8192 * 256 * 4 * 15  # the table's rows, gathered over 16 ranks
        want -= 1_000_000 * 4 * 15 / 16  # the candidate ids, gathered over 16 ranks
        assert port[key]["wire_bytes"] <= ref[key]["wire_bytes"]
    assert got == want


def test_port_own_figures(ref, port):
    tt = port[_key("tt_retrieval", "bebr_sdc", False)]
    assert tt["collectives"]["all-reduce"] == 65_280 == \
        ref[_key("tt_retrieval", "bebr_sdc", False)]["collectives"]["all-reduce"]
    assert tt["replicated"] == {}
    base = port[_key("gnn_ogb", "baseline", False)]
    assert base["flops"] == ref[_key("gnn_ogb", "baseline", False)]["flops"]
    part, rpart = port[_key("gnn_ogb", "partitioned", False)], \
        ref[_key("gnn_ogb", "partitioned", False)]
    assert part["collectives"]["all-gather"] == rpart["collectives"]["all-gather"]
    assert part["collectives"]["reduce-scatter"] == rpart["collectives"]["reduce-scatter"]
    assert part["flops"] == 1_890_748_591_872 <= rpart["flops"] == 1_904_855_707_392


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("variant", TT)
def test_tt_retrieval_against_the_reference(ref, port, variant, multi_pod):
    """Each variant on both meshes by ``hold_record``. float_index's matrix-
    vector product over the million candidates runs on each rank's rows;
    the peak counts the pieces of the arguments the step reads (the BEBR
    variants never read the item table or tower), as XLA prunes a jitted
    step's unused arguments; a sharded top k selects from the gathered
    scores a chunk of columns at a time (``select_topk``)."""
    key = _key("tt_retrieval", variant, multi_pod)
    print(f"{key}: {ratios(port[key], ref[key])}")
    hold_record("tt_retrieval", variant, port[key], ref[key], mesh=hc.mesh_name(multi_pod))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_committed_tt_records_equal_the_reference(ref, multi_pod):
    with open(CELL_RECORDS if not multi_pod else MULTI_POD_RECORDS) as f:
        committed = json.load(f)
    for variant in TT:
        key = _key("tt_retrieval", variant, multi_pod)
        assert {f: v for f, v in ref[key].items() if not f.endswith("_ms")} == committed[key]


def test_records_are_priced_with_the_h100_constants(port):
    for rec in port.values():
        assert rec["compute_ms"] == 1e3 * rec["flops"] / defaults.PEAK_FLOPS
        assert rec["memory_ms"] == 1e3 * rec["bytes"] / defaults.HBM_BW
        assert rec["wire_bytes"] == sum(rec["collectives"].values())
        assert rec["collective_ms"] == 1e3 * rec["wire_bytes"] / (
            defaults.N_LINKS * defaults.LINK_BW)
    assert (defaults.PEAK_FLOPS, defaults.HBM_BW, defaults.LINK_BW, defaults.N_LINKS) == \
        (989.4e12, 3.35e12, 25e9, 18)


def test_no_tpu_figure_in_the_port():
    pattern = re.compile(r"\b(197e12|819e9|50e9)\b")
    for dirpath, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), os.path.join(dirpath, name)


def test_cli_writes_and_merges(tmp_path):
    out = tmp_path / "perf.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for variant in ("bebr_sdc", "bebr_sdc_merge"):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.hillclimb", "--cell",
                               "tt_retrieval", "--variant", variant, "--out", str(out)],
                              capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert f"tt_retrieval|{variant}|16x16: compute=" in proc.stdout
    log = json.loads(out.read_text())
    assert sorted(log) == ["tt_retrieval|bebr_sdc_merge|16x16", "tt_retrieval|bebr_sdc|16x16"]
    rec = log["tt_retrieval|bebr_sdc_merge|16x16"]
    assert rec["ok"] and {"flops", "bytes", "wire_bytes", "collectives", "compute_ms",
                          "memory_ms", "collective_ms", "peak_gib", "run_s"} <= set(rec)
    assert rec["collectives"]["all-gather"] == 12_000
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.hillclimb", "--cell",
                          "tt_retrieval", "--variant", "nope", "--out", str(out)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert bad.returncode != 0 and "bebr_sdc_merge" in bad.stderr


# ---------------------------------------------------------------------------
# bebr_sdc_merge with values: 8 gloo ranks against the reference's 8 devices.
# ---------------------------------------------------------------------------

N_CAND, CODE_DIM, N_LEVELS = 4000, 64, 4
# inverse norms <= 0 on every leaf: 0, -0.0, and negative values large enough
# (-50 flips a negative affine score far above the others) to reach the top k
PLANTED = {3: 0.0, 998: -0.0, 1500: -0.5, 2001: 0.0, 3999: -3.0,
           **{i: -50.0 for i in range(7, N_CAND, 250)}}

_REF_MERGE = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import registry
from repro.launch import hillclimb as hc

entry = registry.REGISTRY["two-tower-retrieval"]
registry.REGISTRY["two-tower-retrieval"] = dataclasses.replace(entry, config=entry.smoke_config)
world = dict(np.load(sys.argv[1]))
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
fn, (param_sh, batch_sh), _ = hc.tt_retrieval_bebr_merge(mesh)
params = {k: v for k, v in world.items() if not k.startswith("batch/")}
tree = {"user_table": params["user_table"], "item_table": params["item_table"],
        "q_tower": [{"w": params[f"q_tower/{i}/w"], "b": params[f"q_tower/{i}/b"]}
                    for i in range(2)],
        "i_tower": [{"w": params[f"i_tower/{i}/w"], "b": params[f"i_tower/{i}/b"]}
                    for i in range(2)],
        "binarizer": {"W": [params[f"W/{t}"] for t in range(4)],
                      "R": [params[f"R/{t}"] for t in range(3)]}}
batch = {k[len("batch/"):]: v for k, v in world.items() if k.startswith("batch/")}
tree = jax.device_put(tree, param_sh)
batch = jax.device_put(batch, batch_sh)
with mesh:
    vals, ids = jax.jit(fn)(tree, batch)
np.savez(sys.argv[2], vals=np.asarray(vals), ids=np.asarray(ids))
"""


def _merge_world(path):
    """The SMOKE two-tower's parameters, a binarizer and one query's batch
    over ``N_CAND`` codes with ``PLANTED`` inverse norms, as numpy."""
    from repro_torch.configs.archs import two_tower as tt_cfg
    from repro_torch.models.recsys import two_tower as tt

    cfg = tt_cfg.SMOKE
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    emb = cfg.tower_mlp[-1]
    world = {"user_table": params["user_table"].numpy(),
             "item_table": params["item_table"].numpy()}
    for tower in ("q_tower", "i_tower"):
        for i, layer in enumerate(params[tower]):
            world[f"{tower}/{i}/w"] = layer["w"].numpy()
            world[f"{tower}/{i}/b"] = layer["b"].numpy()
    for t in range(N_LEVELS):
        world[f"W/{t}"] = (rng.normal(size=(emb, CODE_DIM)) / emb**0.5).astype(np.float32)
    for t in range(N_LEVELS - 1):
        world[f"R/{t}"] = (rng.normal(size=(CODE_DIM, emb)) / CODE_DIM**0.5).astype(np.float32)
    inv = rng.uniform(0.05, 0.2, N_CAND).astype(np.float32)
    for doc, value in PLANTED.items():
        inv[doc] = value
    world["batch/hist_ids"] = rng.integers(0, cfg.user_vocab, (1, cfg.hist_len)).astype(np.int32)
    world["batch/hist_mask"] = np.ones((1, cfg.hist_len), np.float32)
    world["batch/cand_codes"] = rng.integers(0, 2**N_LEVELS, (N_CAND, CODE_DIM)).astype(np.int8)
    world["batch/cand_inv"] = inv
    np.savez(path, **world)
    return world


_PORT_TREE = """
import numpy as np, torch


def port_tree(world, n_levels):
    t = {k: torch.from_numpy(v) for k, v in world.items()}
    params = {"user_table": t["user_table"], "item_table": t["item_table"],
              "q_tower": [{"w": t[f"q_tower/{i}/w"], "b": t[f"q_tower/{i}/b"]} for i in range(2)],
              "i_tower": [{"w": t[f"i_tower/{i}/w"], "b": t[f"i_tower/{i}/b"]} for i in range(2)],
              "binarizer": {"W": [t[f"W/{i}"] for i in range(n_levels)],
                            "R": [t[f"R/{i}"] for i in range(n_levels - 1)]}}
    batch = {k[len("batch/"):]: v for k, v in t.items() if k.startswith("batch/")}
    return params, batch
"""

_RANK = _PORT_TREE + """
import dataclasses, sys
import torch.distributed as dist
from repro_torch.configs import registry
from repro_torch.launch import hillclimb as hc
from repro_torch.launch.mesh import LeafMesh
from repro_torch.parallel import spmd

torch.set_num_threads(1)
rank, addr, world_path, out_path, n_cand, n_levels = sys.argv[1:7]
rank, n_cand, n_levels = int(rank), int(n_cand), int(n_levels)
entry = registry.REGISTRY["two-tower-retrieval"]
registry.REGISTRY["two-tower-retrieval"] = dataclasses.replace(entry, config=entry.smoke_config)
dist.init_process_group("gloo", init_method=addr, world_size=8, rank=rank)
try:
    mesh = LeafMesh((4, 2), ("data", "model"), ["cpu"] * 8)
    with spmd.bind(mesh):
        fn, shardings, _ = hc.tt_retrieval_bebr_merge(mesh, n_cand=n_cand)
        params, batch = port_tree(dict(np.load(world_path)), n_levels)
        vals, ids = spmd.run(fn, (params, batch), shardings)
        vals, ids = vals.full_tensor(), ids.full_tensor()
    np.savez(out_path, vals=vals.numpy(), ids=ids.numpy())
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_merge_on_eight_gloo_ranks_equals_the_reference(tmp_path):
    world_path, ref_path = str(tmp_path / "world.npz"), str(tmp_path / "ref.npz")
    world = _merge_world(world_path)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF_MERGE), world_path,
                               ref_path], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs += [subprocess.Popen([sys.executable, "-c", _RANK, str(r), addr, world_path,
                                str(tmp_path / f"rank{r}.npz"), str(N_CAND), str(N_LEVELS)],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for r in range(8)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    want = np.load(ref_path)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(8)]
    for g in got:  # every rank holds the merged result
        np.testing.assert_array_equal(g["ids"], want["ids"])
        np.testing.assert_allclose(g["vals"], want["vals"], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(g["vals"].view(np.int32), got[0]["vals"].view(np.int32))

    # the port's unsharded bebr_sdc on the same world: the same bits
    from repro_torch.configs.archs import two_tower as tt_cfg
    from repro_torch.train import steps

    scope = {}
    exec(_PORT_TREE, scope)
    params, batch = scope["port_tree"](world, N_LEVELS)
    vals, ids = steps.tt_retrieval_bebr_step(tt_cfg.SMOKE, k=100, code_dim=CODE_DIM,
                                             n_levels=N_LEVELS)(params, batch)
    np.testing.assert_array_equal(got[0]["ids"], ids.numpy())
    np.testing.assert_array_equal(got[0]["vals"].view(np.int32), vals.numpy().view(np.int32))
    planted = [d for d in PLANTED if d in set(ids[0].tolist())]
    assert planted, "no planted candidate reached the top k: the case tests nothing"
