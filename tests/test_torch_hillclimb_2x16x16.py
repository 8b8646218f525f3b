"""Hillclimb's LM variants (llama3-405b train_4k's 12, grok-1
prefill_32k's 2) on the multi-pod 2x16x16 mesh, at 2 layers and the
production widths, against the reference's GSPMD records of the same at
2 layers, run live in one subprocess (``tests/_torch_hillclimb_ref.py``),
by ``hold_record``: nothing replicated, no strided layout redistributed,
FLOPs a device and wire at most the reference's, the peak at most twice
its. The full-depth records are held on the card (``chip_smoke.py`` phase
14, against ``tests/_torch_hillclimb_ref_2x16x16.json``).

FLOPs a device equal the reference's for 11 of the llama3-405b variants.
``microbatch16`` cuts 256 rows into microbatches of 16, which the 32
data-parallel shards of pod x data do not divide: the port splits each
over data and keeps it whole over pod (``steps._rows_like``), where GSPMD
pads it to 32 rows, so its FLOPs a device are the other variants' (the
step's share) and half the reference's.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

from _torch_hillclimb_ref import hold_record, port_record, ratios, run_reference  # noqa: E402
from repro_torch.launch import hillclimb as hc  # noqa: E402

N_LAYERS = 2
MESH = "2x16x16"
VARIANTS = [(c, v) for c in ("llama405b_train", "grok_prefill") for v in sorted(hc.VARIANTS[c])]


@functools.lru_cache(maxsize=None)
def _measured(cell, variant):
    return port_record(cell, variant, True, N_LAYERS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("hillclimb_2x16x16"),
                         [["llama405b_train", "*", True], ["grok_prefill", "*", True]],
                         n_layers=N_LAYERS)


@pytest.mark.parametrize("cell,variant", VARIANTS)
def test_variant_against_the_reference(ref, cell, variant):
    rec, r = _measured(cell, variant), ref[f"{cell}|{variant}|{MESH}"]
    print(f"{cell} {variant} on {MESH}: {ratios(rec, r)}")
    hold_record(cell, variant, rec, r, mesh=MESH)


@pytest.mark.parametrize("variant", sorted(hc.VARIANTS["llama405b_train"]))
def test_llama_flops(ref, variant):
    rec, r = _measured("llama405b_train", variant), ref[f"llama405b_train|{variant}|{MESH}"]
    if variant == "microbatch16":
        base = ref[f"llama405b_train|baseline|{MESH}"]
        assert r["flops"] == 2 * base["flops"]  # GSPMD's 16 rows padded to 32
        assert rec["flops"] == _measured("llama405b_train", "baseline")["flops"] == base["flops"]
    else:
        assert rec["flops"] == r["flops"]
