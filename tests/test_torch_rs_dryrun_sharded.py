"""The dry run's 16 recsys cells (dlrm-rm2, two-tower, MIND and DIEN x
``RS_SHAPES``) sharded on 16x16 at full config, on the meta device over a
fake process group, held to the reference's GSPMD records of the same
cells, run live in one subprocess (``tests/_torch_hillclimb_ref.py``), by
``hold_record``: nothing replicated, no strided layout redistributed,
FLOPs a device and wire at most the reference's, the peak at most twice
its. The live records are also compared with the committed ones
(``tests/_torch_hillclimb_ref_cells.json``) that ``chip_smoke.py``'s phase
14 reads on the card.

With values: each cell's step at its ``SMOKE`` config and small batches,
sharded over 8 gloo ranks on a (4, 2) mesh, equals the same step on one
device (``tests/_torch_cells_gloo.py``): the train steps' gradients and
losses, the serve and retrieval steps' outputs.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cells_gloo import close, gloo_results  # noqa: E402
from _torch_hillclimb_ref import (CELL_RECORDS, RS_ARCHS, RS_SHAPES, RS_WANTED,  # noqa: E402
                                  hold_record, ratios, records)

CELLS = [(arch, shape) for arch in RS_ARCHS for shape in RS_SHAPES]
with open(CELL_RECORDS) as _f:
    COMMITTED = json.load(_f)


def _key(arch, shape):
    return f"{arch}|{shape}|16x16"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return records(tmp_path_factory.mktemp("rs_cells"), RS_WANTED)


@functools.lru_cache(maxsize=None)
def _measured(arch, shape):
    from repro_torch.configs.registry import build_cell
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=False, devices=["meta"] * 256)
    cell = build_cell(arch, shape, mesh)
    return hc._measure(cell.fn, cell.in_shardings, cell.abstract_args, mesh)


def test_the_records_cover_the_cells(ref):
    assert sorted(ref) == sorted(_key(*c) for c in CELLS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_committed_record_equals_the_reference(ref, arch, shape):
    assert ref[_key(arch, shape)] == COMMITTED[_key(arch, shape)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_rs_cell_against_the_reference(ref, arch, shape):
    rec, r = _measured(arch, shape), ref[_key(arch, shape)]
    print(f"{arch} {shape}: {ratios(rec, r)}")
    hold_record(arch, shape, rec, r)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return gloo_results(tmp_path_factory.mktemp("rs_gloo"), CELLS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_sharded_step_equals_unsharded(gloo, arch, shape):
    from repro_torch.models.recsys.dien import SHIFT_INVARIANT_LEAVES

    name = f"{arch}|{shape}|"
    keys = [k[:-2] for k in gloo if k.startswith(name) and k.endswith("|u")]
    assert keys
    for k in keys:
        want, got = gloo[k + "|u"], gloo[k + "|s"]
        if want.dtype == np.int64:  # top-k ids
            np.testing.assert_array_equal(got, want)
            continue
        leaf = k.split("|grad|")[-1]
        # a gradient that is rounding noise, held against its partner's scale
        partner = SHIFT_INVARIANT_LEAVES.get(leaf) if arch == "dien" else None
        scale = np.abs(gloo[f"{name}grad|{partner}|u"]).max() if partner else None
        close(got, want, scale=scale)
