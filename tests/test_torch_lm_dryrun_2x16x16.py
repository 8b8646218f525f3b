"""The dry run's 20 LM cells (the registry's five LM ids x ``LM_SHAPES``)
sharded on the multi-pod 2x16x16 mesh, at 2 layers and full widths, on the
meta device over a fake process group of 512 ranks: nothing runs
replicated, and for the dense models each device's FLOPs are exactly the
whole step's over 512. Each cell is held against the reference's GSPMD
record of the same cell at 2 layers on 2x16x16, run live in one subprocess
(``tests/_torch_hillclimb_ref.py``), by ``hold_record`` (``MOE_TARGETS``
for the MoE models, their share over 512), as
``tests/test_torch_lm_dryrun_sharded.py`` holds them on 16x16.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import (DENSE_ARCHS, LM_ARCHS, LM_SHAPES, hold_record,  # noqa: E402
                                  port_record, ratios, run_reference)

N_LAYERS = 2
MESH = "2x16x16"
CELLS = [(arch, shape) for arch in LM_ARCHS for shape in LM_SHAPES]


@functools.lru_cache(maxsize=None)
def _measured(arch, shape):
    return port_record(arch, shape, True, N_LAYERS, whole=True)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("lm_cells_2x16x16"),
                         [[arch, shape, True] for arch, shape in CELLS], n_layers=N_LAYERS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_lm_cell_sharded(arch, shape):
    rec, whole = _measured(arch, shape)
    assert rec["ok"] and rec["replicated"] == {}, rec["replicated_at"]
    if arch in DENSE_ARCHS:
        assert rec["flops"] * 512 == whole


@pytest.mark.parametrize("arch,shape", CELLS)
def test_lm_cell_against_the_reference(ref, arch, shape):
    rec, whole = _measured(arch, shape)
    r = ref[f"{arch}|{shape}|{MESH}"]
    print(f"{arch} {shape} on {MESH}: {ratios(rec, r)}; {rec['flops'] * 512 / whole:.4f}x "
          f"the share")
    hold_record(arch, shape, rec, r, whole, MESH)
