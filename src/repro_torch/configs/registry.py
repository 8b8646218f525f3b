"""Architecture registry (ports ``repro/configs/registry.py``): ``--arch
<id>`` resolves here.

Each entry: family, full production config, reduced smoke config and
shape ids. The port holds the recsys family; the reference's LM and GNN
ids are known by name and refused with their family, which is not yet
ported. The reference's cell builders (``configs/cells.py``, the dry-run's
launch specification) are not ported either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.configs.archs import dien_cfg, dlrm_rm2, mind_cfg, two_tower


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str  # recsys (lm | gnn in the reference)
    config: Any
    smoke_config: Any
    shapes: Tuple[str, ...]
    notes: str = ""


RS_SHAPE_IDS = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

# The reference's other arch ids, by family: not yet ported.
NOT_PORTED = {
    "llama3-405b": "lm", "llama3.2-1b": "lm", "mistral-large-123b": "lm",
    "llama4-scout-17b-a16e": "lm", "grok-1-314b": "lm", "meshgraphnet": "gnn",
}

REGISTRY: Dict[str, ArchEntry] = {}


def _register(entry: ArchEntry):
    REGISTRY[entry.arch_id] = entry


_register(ArchEntry("mind", "recsys", mind_cfg.CONFIG, mind_cfg.SMOKE, RS_SHAPE_IDS,
                    notes="[arXiv:1904.08030]"))
_register(ArchEntry("dlrm-rm2", "recsys", dlrm_rm2.CONFIG, dlrm_rm2.SMOKE, RS_SHAPE_IDS,
                    notes="[arXiv:1906.00091]"))
_register(ArchEntry("two-tower-retrieval", "recsys", two_tower.CONFIG, two_tower.SMOKE,
                    RS_SHAPE_IDS,
                    notes="sampled-softmax retrieval [RecSys'19]; the paper's native EBR arch"))
_register(ArchEntry("dien", "recsys", dien_cfg.CONFIG, dien_cfg.SMOKE, RS_SHAPE_IDS,
                    notes="[arXiv:1809.03672]"))


def get_arch(arch_id: str) -> ArchEntry:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is of the {NOT_PORTED[arch_id]} family, which is not yet ported "
            f"to repro_torch; ported: {sorted(REGISTRY)}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
