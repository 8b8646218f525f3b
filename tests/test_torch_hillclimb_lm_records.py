"""The JAX reference's full-depth GSPMD records of the LM cells
(``tests/_torch_hillclimb_ref_lm.json``, written by
``tests/_torch_hillclimb_ref.py``), which ``chip_smoke.py``'s phase 14
holds the port to on the card, where no JAX runs: regenerated here from the
reference and compared with the committed file, record by record. Two of
them also hold the port at full depth here: decode_32k's FLOPs a device
equal, grok-1 prefill's at most the reference's.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import LM_ARCH, LM_RECORDS, lm_records  # noqa: E402

with open(LM_RECORDS) as _f:
    COMMITTED = json.load(_f)


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    return lm_records(tmp_path_factory.mktemp("hillclimb_lm_records"))


def test_the_records_cover_the_lm_cells(fresh):
    assert sorted(fresh) == sorted(COMMITTED)
    assert len(COMMITTED) == 16  # 12 llama3-405b train, 2 grok-1 prefill, decode, prefill


@pytest.mark.parametrize("key", sorted(COMMITTED))
def test_committed_record_equals_the_reference(fresh, key):
    assert fresh[key] == COMMITTED[key]


@pytest.mark.parametrize("cell,variant,exact", [(LM_ARCH, "decode_32k", True),
                                                ("grok_prefill", "baseline", False)])
def test_port_at_full_depth(cell, variant, exact):
    from repro_torch.configs import cells as cells_mod
    from repro_torch.configs.archs import llama3_405b
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=False, devices=["meta"] * 256)
    if cell == LM_ARCH:
        spec = cells_mod.lm_cell(llama3_405b.CONFIG, variant, mesh)
        args = (spec.fn, spec.in_shardings, spec.abstract_args)
    else:
        args = hc.VARIANTS[cell][variant](mesh)
    rec = hc._measure(*args, mesh)
    ref = COMMITTED[f"{cell}|{variant}|16x16"]
    assert rec["replicated"] == {}, rec["replicated_at"]
    assert rec["flops"] == ref["flops"] if exact else rec["flops"] <= ref["flops"]
    assert rec["wire_bytes"] <= ref["wire_bytes"]
    assert rec["peak_gib"] <= 2 * ref["peak_gib"]
