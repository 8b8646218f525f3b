"""A running top-k over a corpus streamed in chunks of documents."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class RunningTopK:
    """The k largest int64 keys per query seen so far, with values carried
    beside them (each a [Q, n] float tensor given with its chunk's keys)."""

    def __init__(self, k: int):
        self.k = k
        self.keys: Optional[torch.Tensor] = None
        self.carried: List[torch.Tensor] = []

    def add(self, keys: torch.Tensor, carried: Sequence[torch.Tensor] = ()) -> None:
        top, at = torch.topk(keys, min(self.k, keys.shape[1]), dim=1)
        new = [torch.gather(c, 1, at) for c in carried]
        if self.keys is not None:
            top = torch.cat([self.keys, top], 1)
            new = [torch.cat([old, c], 1) for old, c in zip(self.carried, new)]
            top, at = torch.topk(top, min(self.k, top.shape[1]), dim=1)
            new = [torch.gather(c, 1, at) for c in new]
        self.keys, self.carried = top, new
