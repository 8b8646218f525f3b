"""The dry run's LM cells (``configs/cells.lm_cell``: the registry's five LM
ids x ``LM_SHAPES``) sharded on 16x16, at 2 layers and full widths, on the
meta device over a fake process group: DTensor places every operator
(nothing runs replicated), and for the dense models (llama3-405b,
llama3.2-1b, mistral-large-123b) each device's FLOPs are exactly the
whole step's over 256: no product runs twice.

All 20 cells are held against the reference's GSPMD records of the same
cells at 2 layers, run live in one subprocess
(``tests/_torch_hillclimb_ref.py``), by ``hold_record``: FLOPs a device at
most the reference's, or for the MoE models by ``MOE_TARGETS`` (at the
whole step's share, or at most 1.2x it where llama4-scout's 40 query
heads split over 16 model shards 3 or 2 a shard); wire at most the
reference's, the peak at most twice its. The loss's log-sum-exp is
vocabulary-parallel (``spmd.class_nll``): llama3.2-1b train_4k, whose
128,256 classes a rank once gathered whole, holds. The same cells on
2x16x16: ``tests/test_torch_lm_dryrun_2x16x16.py``.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import (DENSE_ARCHS, LM_SHAPES, MOE_ARCHS, MOE_TARGETS,  # noqa: E402
                                  hold_record, port_record, ratios, run_reference)

DENSE = DENSE_ARCHS
MOE = MOE_ARCHS
N_LAYERS = 2
MESH = "16x16"


@functools.lru_cache(maxsize=None)
def _measured(arch, shape):
    """The cell at 2 layers: its sharded record and the whole step's FLOPs."""
    return port_record(arch, shape, False, N_LAYERS, whole=True)


@pytest.mark.parametrize("shape", sorted(LM_SHAPES))
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_lm_cell_sharded(arch, shape):
    rec, whole = _measured(arch, shape)
    assert rec["ok"] and rec["replicated"] == {}, rec["replicated_at"]
    if arch in DENSE:
        assert rec["flops"] * 256 == whole


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("lm_cells"),
                         [[arch, shape, False] for arch in DENSE + MOE for shape in LM_SHAPES],
                         n_layers=N_LAYERS)


def _hold(ref, arch, shape):
    rec, whole = _measured(arch, shape)
    r = ref[f"{arch}|{shape}|{MESH}"]
    print(f"{arch} {shape}: {ratios(rec, r)}; {rec['flops'] * 256 / whole:.4f}x the share")
    hold_record(arch, shape, rec, r, whole, MESH)


@pytest.mark.parametrize("arch,shape", sorted(MOE_TARGETS))
def test_moe_cell_against_the_reference(ref, arch, shape):
    _hold(ref, arch, shape)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in DENSE for s in sorted(LM_SHAPES)])
def test_dense_cell_against_the_reference(ref, arch, shape):
    _hold(ref, arch, shape)
