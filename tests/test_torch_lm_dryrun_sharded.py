"""The dry run's LM cells (``configs/cells.lm_cell``: the registry's five LM
ids x ``LM_SHAPES``) sharded on 16x16, at 2 layers and full widths, on the
meta device over a fake process group: DTensor places every operator
(nothing runs replicated), and for the dense models (llama3-405b,
llama3.2-1b, mistral-large-123b) each device's FLOPs are exactly the
whole step's over 256: no product runs twice. The MoE models' figures are
the port's own (PERF.md section 7): llama4-scout's 40 query heads do not
split over 16 shards, so every shard attends with all of them.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import cells as cells_mod  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import hillclimb as hc  # noqa: E402
from repro_torch.launch import hlo_cost  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

DENSE = ("llama3-405b", "llama3.2-1b", "mistral-large-123b")
MOE = ("llama4-scout-17b-a16e", "grok-1-314b")


@pytest.mark.parametrize("shape", sorted(cells_mod.LM_SHAPES))
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_lm_cell_sharded(arch, shape):
    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=False, devices=["meta"] * 256)
    cell = cells_mod.lm_cell(dataclasses.replace(get_arch(arch).config, n_layers=2), shape, mesh)
    rec = hc._measure(cell.fn, cell.in_shardings, cell.abstract_args, mesh)
    assert rec["ok"] and rec["replicated"] == {}, rec["replicated_at"]
    if arch in DENSE:
        whole = hlo_cost.step_costs(cell.fn, *cell.abstract_args)["flops"]
        assert rec["flops"] * 256 == whole
