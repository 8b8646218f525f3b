"""The dry run's 4 meshgraphnet cells (``GNN_SHAPES``) and hillclimb's 7
``gnn_ogb`` variants sharded on 16x16 at full config, on the meta device
over a fake process group, held to the reference's GSPMD records of the
same, run live in one subprocess (``tests/_torch_hillclimb_ref.py``), by
``hold_record``: nothing replicated, no strided layout redistributed,
FLOPs a device and wire at most the reference's, the peak at most twice
its. Each layer's checkpoint keeps its collectives' results
(``spmd.checkpoint``), so the backward pass runs none of them again. The
live records are also compared with the committed ones
(``tests/_torch_hillclimb_ref_cells.json``) that ``chip_smoke.py``'s phase
14 reads on the card.

With values: each meshgraphnet cell's train step at the ``SMOKE`` config on
a graph of 64 nodes and 256 edges, sharded over 8 gloo ranks on a (4, 2)
mesh, has the gradients and loss of the same step on one device
(``tests/_torch_cells_gloo.py``).
"""

import functools
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_cells_gloo import close, gloo_results  # noqa: E402
from _torch_hillclimb_ref import (CELL_RECORDS, GNN_SHAPES, GNN_WANTED, hold_record,  # noqa: E402
                                  ratios, records)

OGB_VARIANTS = ("baseline", "halo_exchange", "halo_hostplan", "node_constrained",
                "node_constrained_bf16", "partitioned", "partitioned_bf16gather")
CELLS = [("meshgraphnet", shape) for shape in GNN_SHAPES] + [
    ("gnn_ogb", variant) for variant in OGB_VARIANTS]
with open(CELL_RECORDS) as _f:
    COMMITTED = json.load(_f)


def _key(cell, variant):
    return f"{cell}|{variant}|16x16"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return records(tmp_path_factory.mktemp("gnn_cells"), GNN_WANTED)


@functools.lru_cache(maxsize=None)
def _measured(cell, variant):
    from repro_torch.configs.registry import build_cell
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=False, devices=["meta"] * 256)
    if cell in hc.VARIANTS:
        return hc._measure(*hc.VARIANTS[cell][variant](mesh), mesh)
    spec = build_cell(cell, variant, mesh)
    return hc._measure(spec.fn, spec.in_shardings, spec.abstract_args, mesh)


def test_the_records_cover_the_cells(ref):
    from repro_torch.launch import hillclimb as hc

    assert sorted(hc.VARIANTS["gnn_ogb"]) == list(OGB_VARIANTS)
    assert sorted(ref) == sorted(_key(*c) for c in CELLS)


@pytest.mark.parametrize("cell,variant", CELLS)
def test_committed_record_equals_the_reference(ref, cell, variant):
    assert ref[_key(cell, variant)] == COMMITTED[_key(cell, variant)]


@pytest.mark.parametrize("cell,variant", CELLS)
def test_gnn_cell_against_the_reference(ref, cell, variant):
    rec, r = _measured(cell, variant), ref[_key(cell, variant)]
    print(f"{cell} {variant}: {ratios(rec, r)}")
    hold_record(cell, variant, rec, r)


def test_the_baseline_is_the_dry_run_cell():
    assert _measured("gnn_ogb", "baseline") == {**_measured("meshgraphnet", "ogb_products"),
                                                "run_s": _measured("gnn_ogb", "baseline")["run_s"]}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return gloo_results(tmp_path_factory.mktemp("gnn_gloo"),
                        [("meshgraphnet", shape) for shape in GNN_SHAPES])


@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_sharded_step_equals_unsharded(gloo, shape):
    name = f"meshgraphnet|{shape}|"
    keys = [k[:-2] for k in gloo if k.startswith(name) and k.endswith("|u")]
    assert any("|grad|" in k for k in keys)
    for k in keys:
        close(gloo[k + "|s"], gloo[k + "|u"])
