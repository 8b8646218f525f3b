"""The JAX reference's hillclimb records (``repro/launch/hillclimb.py``'s
``_measure``) of a few variants, dumped to JSON by one subprocess with 512
forced host devices (the device count locks at JAX's first use, so the
test process stays single-device). Used by ``tests/test_torch_hillclimb*.py``,
``tests/test_torch_*_dryrun_*.py`` and, through the committed files
below, by ``chip_smoke.py``'s phase 14.

Each record is the reference's ``_measure`` output without ``compile_s``,
keyed ``cell|variant|mesh``. A wanted entry is ``(cell, variant,
multi_pod)``: a cell of the reference's ``VARIANTS`` (variant ``"*"`` for
all of them), or an arch id of the registry (``configs/registry``) with
one of its shapes, for that arch's cell as the dry run builds it
(``build_cell``). With ``n_layers`` every LM cell is built at that depth
(``configs/cells.lm_cell`` patched), widths unchanged.

Run as a script, it writes the full-depth records of all 132 (cell or
variant, mesh) pairs that phase 14 holds: ``LM_RECORDS``, the 16x16
records of the 20 LM dry-run cells (``LM_ARCHS`` x ``LM_SHAPES``) and of
the llama405b_train and grok_prefill variants (``LM_WANTED``, 34);
``CELL_RECORDS``, the 16x16 records of the 20 other dry-run cells (the
recsys archs x ``RS_SHAPES``, meshgraphnet x ``GNN_SHAPES``) and of the
gnn_ogb and tt_retrieval variants (``CELL_WANTED``, 32); and
``MULTI_POD_RECORDS``, the 2x16x16 records of all 66 (``MULTI_POD_WANTED``),
about 15 min on 8 cores, most of it the reference compiling gnn_ogb:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_hillclimb_ref.py
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
LM_RECORDS = os.path.join(HERE, "_torch_hillclimb_ref_lm.json")
CELL_RECORDS = os.path.join(HERE, "_torch_hillclimb_ref_cells.json")
MULTI_POD_RECORDS = os.path.join(HERE, "_torch_hillclimb_ref_2x16x16.json")
LM_ARCH = "llama3-405b"
DENSE_ARCHS = (LM_ARCH, "llama3.2-1b", "mistral-large-123b")
MOE_ARCHS = ("llama4-scout-17b-a16e", "grok-1-314b")
LM_ARCHS = DENSE_ARCHS + MOE_ARCHS
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
RS_ARCHS = ("dlrm-rm2", "two-tower-retrieval", "mind", "dien")
RS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RS_WANTED = [[arch, shape, False] for arch in RS_ARCHS for shape in RS_SHAPES]
GNN_WANTED = [["meshgraphnet", shape, False] for shape in GNN_SHAPES] + [["gnn_ogb", "*", False]]
TT_WANTED = [["tt_retrieval", "*", False]]
CELL_WANTED = RS_WANTED + GNN_WANTED + TT_WANTED
# what each MoE cell's FLOPs a device must be at most, on either mesh at any
# depth: (a multiple of the whole step's share, the port's own whole-step
# FLOPs over the device count, 256 or 512; a multiple of the reference's
# GSPMD record), None where not bounded. 1.2 is llama4-scout's ceiling of 40
# query heads over 16 model shards (3 a shard at most, against a share of
# 2.5); 1.229 grok-1 prefill's figure before its dispatch was split.
MOE_TARGETS = {
    ("llama4-scout-17b-a16e", "train_4k"): (1.2, None),
    ("llama4-scout-17b-a16e", "prefill_32k"): (1.2, None),
    ("llama4-scout-17b-a16e", "decode_32k"): (None, 1.0),
    ("llama4-scout-17b-a16e", "long_500k"): (1.2, None),
    ("grok-1-314b", "train_4k"): (None, 1.0),
    ("grok-1-314b", "prefill_32k"): (1.229, 1.0),
    ("grok-1-314b", "decode_32k"): (1.001, None),
    ("grok-1-314b", "long_500k"): (1.001, None),
}


def n_devices(mesh: str) -> int:
    """The device count of a mesh by its name, "16x16" or "2x16x16"."""
    return 512 if mesh == "2x16x16" else 256


def hold_record(cell, variant, rec, ref, whole=None, mesh="16x16") -> None:
    """Assert a port record of a dry-run cell or hillclimb variant
    (``hillclimb._measure``) on ``mesh`` against the reference's record
    ``ref`` of the same: nothing replicated and no strided layout
    redistributed (a view that flattens a split dim), wire at most the
    reference's, the peak at most twice its, and the FLOPs a device at most
    the reference's, or for an entry of ``MOE_TARGETS`` as it says
    (``whole``: the step's FLOPs on one device, for a bound by the share,
    over the mesh's 256 or 512 devices)."""
    share, at_ref = MOE_TARGETS.get((cell, variant), (None, 1.0))
    assert rec["replicated"] == {}, rec["replicated_at"]
    assert rec["strided"] == {}, rec["strided"]
    if share is not None:
        n = n_devices(mesh)
        assert rec["flops"] <= share * whole / n, (rec["flops"], whole / n)
    if at_ref is not None:
        assert rec["flops"] <= at_ref * ref["flops"], (rec["flops"], ref["flops"])
    assert rec["wire_bytes"] <= ref["wire_bytes"], (rec["wire_bytes"], ref["wire_bytes"])
    assert rec["peak_gib"] <= 2 * ref["peak_gib"], (rec["peak_gib"], ref["peak_gib"])


def port_record(cell, variant, multi_pod=False, n_layers=0, whole=False):
    """The port's record (``hillclimb._measure``) of a dry-run cell (a
    registry arch id and one of its shapes) or a hillclimb variant on the
    production mesh (meta leaves, a fake process group), every LM cell at
    ``n_layers`` (0: full depth); with ``whole``, (record, the whole step's
    FLOPs on one device)."""
    import dataclasses

    import torch

    from repro_torch.configs import cells as cells_mod
    from repro_torch.configs.registry import build_cell, get_arch
    from repro_torch.launch import hillclimb as hc
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * n_devices(hc.mesh_name(multi_pod)))
    lm_cell = cells_mod.lm_cell
    if n_layers:
        cells_mod.lm_cell = lambda cfg, shape, m: lm_cell(
            dataclasses.replace(cfg, n_layers=n_layers), shape, m)
    try:
        if cell in hc.VARIANTS:
            args = hc.VARIANTS[cell][variant](mesh)
        else:
            entry = get_arch(cell)
            spec = (cells_mod.lm_cell(entry.config, variant, mesh) if entry.family == "lm"
                    else build_cell(cell, variant, mesh))
            args = (spec.fn, spec.in_shardings, spec.abstract_args)
        rec = hc._measure(*args, mesh)
        return (rec, hlo_cost.step_costs(args[0], *args[2])["flops"]) if whole else rec
    finally:
        cells_mod.lm_cell = lm_cell


def ratios(rec, ref) -> str:
    """Port / reference of a record's FLOPs, wire and peak, for a test's output."""
    return (f"FLOPs {rec['flops']:.6e} ({rec['flops'] / ref['flops']:.4f}x the reference's), "
            f"wire {rec['wire_bytes']:.4e} B ({rec['wire_bytes'] / ref['wire_bytes']:.4f}x), "
            f"peak {rec['peak_gib']:.3f} GiB ({rec['peak_gib'] / ref['peak_gib']:.4f}x)")


LM_VARIANTS = [["llama405b_train", "*", False], ["grok_prefill", "*", False]]
LM_CELLS = [[arch, shape, False] for arch in LM_ARCHS for shape in LM_SHAPES]
LM_WANTED = LM_VARIANTS + LM_CELLS
MULTI_POD_WANTED = [[cell, variant, True] for cell, variant, _ in LM_WANTED + CELL_WANTED]

_SCRIPT = r"""
import dataclasses, json, sys
from repro.configs import cells as cells_mod
from repro.configs.registry import build_cell, get_arch
from repro.launch import hillclimb as hc
from repro.launch.mesh import make_production_mesh

out_path, wanted, n_layers = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
if n_layers:
    lm_cell = cells_mod.lm_cell
    cells_mod.lm_cell = lambda cfg, shape_id, mesh: lm_cell(
        dataclasses.replace(cfg, n_layers=n_layers), shape_id, mesh)
out = {}
for cell, variant, multi_pod in wanted:
    mesh = make_production_mesh(multi_pod=multi_pod)
    names = sorted(hc.VARIANTS[cell]) if variant == "*" else [variant]
    for name in names:
        if cell not in hc.VARIANTS:  # a registry arch id and one of its shapes
            entry = get_arch(cell)
            spec = (cells_mod.lm_cell(entry.config, name, mesh) if entry.family == "lm"
                    else build_cell(cell, name, mesh))
            fn, shardings, abstract = spec.fn, spec.in_shardings, spec.abstract_args
        else:
            fn, shardings, abstract = hc.VARIANTS[cell][name](mesh)
        res = hc._measure(fn, shardings, abstract, mesh, mesh.devices.size)
        res.pop("compile_s")
        out[f"{cell}|{name}|{'2x16x16' if multi_pod else '16x16'}"] = res
out["variants"] = {c: sorted(v) for c, v in hc.VARIANTS.items()}
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def run_reference(tmp_path, wanted, n_layers: int = 0, timeout: float = 600) -> dict:
    """The reference's records of ``wanted``, a list of (cell, variant,
    multi_pod), plus ``variants``: each cell's variant names."""
    out = os.path.join(str(tmp_path), "hillclimb_ref.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_SCRIPT), out,
                           json.dumps(wanted), str(n_layers)],
                          capture_output=True, text=True, env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def records(tmp_path, wanted, n_layers: int = 0, timeout: float = 600) -> dict:
    """The records of ``wanted`` as ``LM_RECORDS``, ``CELL_RECORDS`` and
    ``MULTI_POD_RECORDS`` hold them (at full depth): the per-device counts
    (FLOPs, bytes, wire by kind, peak), without the reference's
    milliseconds (priced with its own accelerator's constants)."""
    recs = run_reference(tmp_path, wanted, n_layers, timeout)
    recs.pop("variants")
    return {k: {f: v for f, v in r.items() if not f.endswith("_ms")} for k, r in recs.items()}


def lm_records(tmp_path) -> dict:
    """``LM_WANTED``'s records, as ``LM_RECORDS`` holds them."""
    return records(tmp_path, LM_WANTED)


def _write_all(jobs: int = 4) -> None:
    """Every committed file, each file's entries in ``jobs`` subprocesses,
    all of them ``jobs`` at a time."""
    from concurrent.futures import ThreadPoolExecutor

    files = ((LM_RECORDS, LM_WANTED), (CELL_RECORDS, CELL_WANTED),
             (MULTI_POD_RECORDS, MULTI_POD_WANTED))
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(jobs) as pool:
        parts = {}
        for j, (path, wanted) in enumerate(files):
            for i in range(jobs):
                os.makedirs(os.path.join(tmp, f"{j}_{i}"))
                parts[(path, i)] = pool.submit(records, os.path.join(tmp, f"{j}_{i}"),
                                               wanted[i::jobs], 0, 3600)
        for path, _ in files:
            recs = {}
            for i in range(jobs):
                recs.update(parts[(path, i)].result())
            with open(path, "w") as f:
                json.dump(recs, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"{len(recs)} records -> {path}")


if __name__ == "__main__":
    _write_all()
