"""Architecture registry (ports ``repro/configs/registry.py``): ``--arch
<id>`` resolves here.

Each entry: family (lm | gnn | recsys), full production config, reduced
smoke config, shape ids, and a cell builder (``configs/cells.py``) that
produces the dry-run specification per (shape x mesh), for all ten of the
reference's ids.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from repro_torch.configs import cells
from repro_torch.configs.archs import (
    dien_cfg,
    dlrm_rm2,
    grok_1_314b,
    llama3_405b,
    llama3_2_1b,
    llama4_scout,
    meshgraphnet,
    mind_cfg,
    mistral_large_123b,
    two_tower,
)


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str  # lm | gnn | recsys
    config: Any
    smoke_config: Any
    shapes: Tuple[str, ...]
    cell_builder: Callable[[Any, str, Any], cells.CellSpec]
    notes: str = ""


LM_SHAPE_IDS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPE_IDS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RS_SHAPE_IDS = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

REGISTRY: Dict[str, ArchEntry] = {}


def _register(entry: ArchEntry):
    REGISTRY[entry.arch_id] = entry


_register(ArchEntry("llama3-405b", "lm", llama3_405b.CONFIG, llama3_405b.SMOKE, LM_SHAPE_IDS,
                    cells.lm_cell, notes="dense GQA, 128k vocab [arXiv:2407.21783]"))
_register(ArchEntry("llama3.2-1b", "lm", llama3_2_1b.CONFIG, llama3_2_1b.SMOKE, LM_SHAPE_IDS,
                    cells.lm_cell, notes="small llama3 [hf:meta-llama/Llama-3.2-1B]"))
_register(ArchEntry("mistral-large-123b", "lm", mistral_large_123b.CONFIG,
                    mistral_large_123b.SMOKE, LM_SHAPE_IDS, cells.lm_cell,
                    notes="[hf:mistralai/Mistral-Large-Instruct-2407]"))
_register(ArchEntry("llama4-scout-17b-a16e", "lm", llama4_scout.CONFIG, llama4_scout.SMOKE,
                    LM_SHAPE_IDS, cells.lm_cell,
                    notes="MoE 16e top-1 [hf:meta-llama/Llama-4-Scout-17B-16E]"))
_register(ArchEntry("grok-1-314b", "lm", grok_1_314b.CONFIG, grok_1_314b.SMOKE, LM_SHAPE_IDS,
                    cells.lm_cell, notes="MoE 8e top-2 [hf:xai-org/grok-1]"))
_register(ArchEntry("meshgraphnet", "gnn", meshgraphnet.CONFIG, meshgraphnet.SMOKE,
                    GNN_SHAPE_IDS, cells.gnn_cell, notes="[arXiv:2010.03409]"))
_register(ArchEntry("mind", "recsys", mind_cfg.CONFIG, mind_cfg.SMOKE, RS_SHAPE_IDS,
                    cells.mind_cell, notes="[arXiv:1904.08030]"))
_register(ArchEntry("dlrm-rm2", "recsys", dlrm_rm2.CONFIG, dlrm_rm2.SMOKE, RS_SHAPE_IDS,
                    cells.dlrm_cell, notes="[arXiv:1906.00091]"))
_register(ArchEntry("two-tower-retrieval", "recsys", two_tower.CONFIG, two_tower.SMOKE,
                    RS_SHAPE_IDS, cells.tt_cell,
                    notes="sampled-softmax retrieval [RecSys'19]; the paper's native EBR arch"))
_register(ArchEntry("dien", "recsys", dien_cfg.CONFIG, dien_cfg.SMOKE, RS_SHAPE_IDS,
                    cells.dien_cell, notes="[arXiv:1809.03672]"))


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def build_cell(arch_id: str, shape_id: str, mesh) -> cells.CellSpec:
    """The cell of ``arch_id``'s production config at ``shape_id`` on ``mesh``
    (a ``launch/mesh.LeafMesh``)."""
    entry = get_arch(arch_id)
    if shape_id not in entry.shapes:
        raise KeyError(f"{arch_id} has shapes {entry.shapes}, not {shape_id!r}")
    return entry.cell_builder(entry.config, shape_id, mesh)


def all_cells() -> Tuple[Tuple[str, str], ...]:
    return tuple((arch_id, s) for arch_id, entry in REGISTRY.items() for s in entry.shapes)
