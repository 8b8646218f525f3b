"""Step builders (ports ``repro/train/steps.py``): the serving steps so far.

The model zoo's training steps (gradient accumulation, clipping, Adam)
come with the zoo; the binarizer's are in ``core/trainer.py``.
"""

from __future__ import annotations

import torch

from repro_torch.models.recsys import dlrm as dlrm_lib


def dlrm_serve_step(cfg: dlrm_lib.DLRMConfig):
    """``step(model, batch) -> logits [B]`` for a ``DLRM`` built from ``cfg``."""

    def step(model: dlrm_lib.DLRM, batch):
        if model.cfg != cfg:
            raise ValueError(f"model built for {model.cfg.name}, step for {cfg.name}")
        with torch.no_grad():
            return model(batch["dense"], batch["sparse_ids"])

    return step
