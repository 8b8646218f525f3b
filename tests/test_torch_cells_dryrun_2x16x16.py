"""The dry run's 20 other cells (the recsys archs x ``RS_SHAPES``,
meshgraphnet x ``GNN_SHAPES``) and hillclimb's 7 ``gnn_ogb`` variants
sharded on the multi-pod 2x16x16 mesh at full config, on the meta device
over a fake process group of 512 ranks, held by ``hold_record`` as
``tests/test_torch_{rs,gnn}_dryrun_sharded.py`` hold them on 16x16:
nothing replicated, no strided layout redistributed, FLOPs a device and
wire at most the reference's, the peak at most twice its.

The 20 cells against the reference's GSPMD records run live in one
subprocess (``tests/_torch_hillclimb_ref.py``), which also equal the
committed ones (``tests/_torch_hillclimb_ref_2x16x16.json``) that
``chip_smoke.py``'s phase 14 reads on the card; the gnn_ogb variants,
whose reference compile takes minutes, against the committed records.
"""

import functools
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import (GNN_SHAPES, MULTI_POD_RECORDS, RS_ARCHS, RS_SHAPES,  # noqa: E402
                                  hold_record, port_record, ratios, records)

MESH = "2x16x16"
CELLS = [(arch, shape) for arch in RS_ARCHS for shape in RS_SHAPES] + [
    ("meshgraphnet", shape) for shape in GNN_SHAPES]
OGB_VARIANTS = ("baseline", "halo_exchange", "halo_hostplan", "node_constrained",
                "node_constrained_bf16", "partitioned", "partitioned_bf16gather")
with open(MULTI_POD_RECORDS) as _f:
    COMMITTED = json.load(_f)


def _key(cell, variant):
    return f"{cell}|{variant}|{MESH}"


@functools.lru_cache(maxsize=None)
def _measured(cell, variant):
    return port_record(cell, variant, True)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return records(tmp_path_factory.mktemp("cells_2x16x16"), [[a, s, True] for a, s in CELLS])


def test_the_records_cover_the_cells(ref):
    assert sorted(ref) == sorted(_key(*c) for c in CELLS)


@pytest.mark.parametrize("cell,variant", CELLS)
def test_committed_record_equals_the_reference(ref, cell, variant):
    assert ref[_key(cell, variant)] == COMMITTED[_key(cell, variant)]


@pytest.mark.parametrize("cell,variant", CELLS)
def test_cell_against_the_reference(ref, cell, variant):
    rec, r = _measured(cell, variant), ref[_key(cell, variant)]
    print(f"{cell} {variant} on {MESH}: {ratios(rec, r)}")
    hold_record(cell, variant, rec, r, mesh=MESH)


@pytest.mark.parametrize("variant", OGB_VARIANTS)
def test_gnn_ogb_variant_against_the_committed_record(variant):
    rec, r = _measured("gnn_ogb", variant), COMMITTED[_key("gnn_ogb", variant)]
    print(f"gnn_ogb {variant} on {MESH}: {ratios(rec, r)}")
    hold_record("gnn_ogb", variant, rec, r, mesh=MESH)
