"""The JAX reference's full-depth GSPMD records of the LM cells
(``tests/_torch_hillclimb_ref_lm.json``, written by
``tests/_torch_hillclimb_ref.py``), which ``chip_smoke.py``'s phase 14
holds the port to on the card, where no JAX runs: regenerated here from the
reference and compared with the committed file, record by record. Four of
them also hold the port at full depth here: llama3-405b decode_32k's FLOPs
a device equal, grok-1 prefill's at most the reference's, and the train
steps of the two MoE models by ``MOE_TARGETS`` (llama4-scout's at most 1.2x
the whole step's share, grok-1's at most the reference's).
"""

import json

import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import (LM_ARCH, LM_RECORDS, MOE_TARGETS, hold_record,  # noqa: E402
                                  lm_records)

with open(LM_RECORDS) as _f:
    COMMITTED = json.load(_f)


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    return lm_records(tmp_path_factory.mktemp("hillclimb_lm_records"))


def test_the_records_cover_the_lm_cells(fresh):
    assert sorted(fresh) == sorted(COMMITTED)
    # 12 llama3-405b train, 2 grok-1 prefill, llama3-405b decode and prefill,
    # and the 8 cells of the two MoE models
    assert len(COMMITTED) == 24
    assert all(f"{arch}|{shape}|16x16" in COMMITTED for arch, shape in MOE_TARGETS)


@pytest.mark.parametrize("key", sorted(COMMITTED))
def test_committed_record_equals_the_reference(fresh, key):
    assert fresh[key] == COMMITTED[key]


@pytest.mark.parametrize("cell,variant,exact", [(LM_ARCH, "decode_32k", True),
                                                ("grok_prefill", "baseline", False),
                                                ("llama4-scout-17b-a16e", "train_4k", None),
                                                ("grok-1-314b", "train_4k", None)])
def test_port_at_full_depth(cell, variant, exact):
    from repro_torch.configs import cells as cells_mod
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=False, devices=["meta"] * 256)
    if cell in hc.VARIANTS:
        args = hc.VARIANTS[cell][variant](mesh)
    else:
        spec = cells_mod.lm_cell(get_arch(cell).config, variant, mesh)
        args = (spec.fn, spec.in_shardings, spec.abstract_args)
    rec = hc._measure(*args, mesh)
    ref = COMMITTED[f"{cell}|{variant}|16x16"]
    if exact is None:  # an MoE cell
        needs_share = MOE_TARGETS[(cell, variant)][0] is not None
        whole = hlo_cost.step_costs(args[0], *args[2])["flops"] if needs_share else None
        hold_record(cell, variant, rec, ref, whole)
        return
    assert rec["replicated"] == {}, rec["replicated_at"]
    assert rec["flops"] == ref["flops"] if exact else rec["flops"] <= ref["flops"]
    assert rec["wire_bytes"] <= ref["wire_bytes"]
    assert rec["peak_gib"] <= 2 * ref["peak_gib"]
