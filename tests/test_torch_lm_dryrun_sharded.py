"""The dry run's LM cells (``configs/cells.lm_cell``: the registry's five LM
ids x ``LM_SHAPES``) sharded on 16x16, at 2 layers and full widths, on the
meta device over a fake process group: DTensor places every operator
(nothing runs replicated), and for the dense models (llama3-405b,
llama3.2-1b, mistral-large-123b) each device's FLOPs are exactly the
whole step's over 256: no product runs twice.

The MoE models' cells (llama4-scout-17b-a16e, grok-1-314b) are held
against the reference's GSPMD records of the same cells at 2 layers, run
live in one subprocess (``tests/_torch_hillclimb_ref.py``), by
``MOE_TARGETS``: FLOPs a device at the whole step's share, or at most 1.2x
it where llama4-scout's 40 query heads split over 16 model shards 3 or 2 a
shard, or at most the reference's; wire at most the reference's, the peak
at most twice its.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import MOE_ARCHS, MOE_TARGETS, hold_record, run_reference  # noqa: E402
from repro_torch.configs import cells as cells_mod  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import hillclimb as hc  # noqa: E402
from repro_torch.launch import hlo_cost  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

DENSE = ("llama3-405b", "llama3.2-1b", "mistral-large-123b")
MOE = MOE_ARCHS
N_LAYERS = 2


@functools.lru_cache(maxsize=None)
def _measured(arch, shape):
    """The cell at 2 layers: its sharded record and the whole step's FLOPs."""
    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=False, devices=["meta"] * 256)
    cfg = dataclasses.replace(get_arch(arch).config, n_layers=N_LAYERS)
    cell = cells_mod.lm_cell(cfg, shape, mesh)
    rec = hc._measure(cell.fn, cell.in_shardings, cell.abstract_args, mesh)
    return rec, hlo_cost.step_costs(cell.fn, *cell.abstract_args)["flops"]


@pytest.mark.parametrize("shape", sorted(cells_mod.LM_SHAPES))
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_lm_cell_sharded(arch, shape):
    rec, whole = _measured(arch, shape)
    assert rec["ok"] and rec["replicated"] == {}, rec["replicated_at"]
    if arch in DENSE:
        assert rec["flops"] * 256 == whole


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("moe_cells"),
                         [[arch, shape, False] for arch, shape in MOE_TARGETS],
                         n_layers=N_LAYERS)


@pytest.mark.parametrize("arch,shape", sorted(MOE_TARGETS))
def test_moe_cell_against_the_reference(ref, arch, shape):
    rec, whole = _measured(arch, shape)
    r = ref[f"{arch}|{shape}|16x16"]
    print(f"{arch} {shape}: FLOPs {rec['flops']:.6e} ({rec['flops'] * 256 / whole:.4f}x the "
          f"share, {rec['flops'] / r['flops']:.4f}x the reference's), wire "
          f"{rec['wire_bytes'] / r['wire_bytes']:.3f}x, peak {rec['peak_gib'] / r['peak_gib']:.3f}x")
    hold_record(arch, shape, rec, r, whole)
