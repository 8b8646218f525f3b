"""The JAX reference's full-depth GSPMD records of the LM cells and
variants on 16x16 (``tests/_torch_hillclimb_ref_lm.json``, written by
``tests/_torch_hillclimb_ref.py``), which ``chip_smoke.py``'s phase 14
holds the port to on the card, where no JAX runs: regenerated here from the
reference and compared with the committed file, record by record. Four of
them also hold the port at full depth here: llama3-405b decode_32k's FLOPs
a device equal, grok-1 prefill's at most the reference's, and the train
steps of the two MoE models by ``MOE_TARGETS`` (llama4-scout's at most 1.2x
the whole step's share, grok-1's at most the reference's). llama3.2-1b
train_4k at full depth (16 layers, its loss over 128,256 classes split
over the model axis) holds on both meshes by ``hold_record`` against the
committed records (the 2x16x16 one in
``tests/_torch_hillclimb_ref_2x16x16.json``).
"""

import json

import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import (LM_ARCH, LM_RECORDS, MOE_TARGETS, MULTI_POD_RECORDS,  # noqa: E402
                                  hold_record, lm_records, port_record, ratios)

with open(LM_RECORDS) as _f:
    COMMITTED = json.load(_f)


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    return lm_records(tmp_path_factory.mktemp("hillclimb_lm_records"))


def test_the_records_cover_the_lm_cells(fresh):
    assert sorted(fresh) == sorted(COMMITTED)
    # 12 llama3-405b train, 2 grok-1 prefill, and the 20 cells of the five
    # LM archs (the 8 of the two MoE models among them)
    assert len(COMMITTED) == 34
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


@pytest.mark.parametrize("multi_pod", [False, True])
def test_llama32_train_at_full_depth(multi_pod):
    mesh = "2x16x16" if multi_pod else "16x16"
    if multi_pod:
        with open(MULTI_POD_RECORDS) as f:
            ref = json.load(f)[f"llama3.2-1b|train_4k|{mesh}"]
    else:
        ref = COMMITTED[f"llama3.2-1b|train_4k|{mesh}"]
    rec = port_record("llama3.2-1b", "train_4k", multi_pod)
    print(f"llama3.2-1b train_4k on {mesh}: {ratios(rec, ref)}")
    hold_record("llama3.2-1b", "train_4k", rec, ref, mesh=mesh)
