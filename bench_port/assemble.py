"""An index of the whole corpus, put together from the port's own build of
each chunk of documents.

The port's builds (``FlatSDC.build``, ``BiGranularFlat.build``) take every
code at once and derive the norms from float32 values of all of them,
more than one card holds at a leaf's size. Both work row by row, so the
harness builds each chunk with them and copies every field of the chunk's
index that holds one row a document (a tensor or a numpy array whose first
dimension is the chunk's length, in nested indexes too) into an array of
the corpus's length, made like the first chunk's: on its device, or in
host memory. How a row is laid out (packing, tiers, norms) stays the
port's decision; the harness relies only on the rows.

The check holds a served index to the port's build over the reference's
codes the same way (``rows_differ``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


def row_fields(index, rows: int, prefix: str = "") -> Dict[str, object]:
    """Every field of ``index`` holding ``rows`` rows, by dotted name."""
    out = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if dataclasses.is_dataclass(v):
            out.update(row_fields(v, rows, f"{prefix}{f.name}."))
        elif isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim >= 1 and v.shape[0] == rows:
            out[prefix + f.name] = v
    return out


def _with(index, arrays: Dict[str, object], prefix: str = ""):
    changes = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = _with(v, arrays, f"{prefix}{f.name}.")
        elif prefix + f.name in arrays:
            changes[f.name] = arrays[prefix + f.name]
    return dataclasses.replace(index, **changes)


def _empty_like(a, n: int):
    if isinstance(a, np.ndarray):
        return np.empty((n,) + a.shape[1:], dtype=a.dtype)
    return torch.empty((n,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)


class Rows:
    """The rows of chunk indexes, added in any order, as one index of ``n`` documents."""

    def __init__(self, n: int):
        self.n = n
        self.first = None
        self.arrays: Dict[str, object] = {}

    def add(self, start: int, rows: int, part) -> None:
        """``part``: the port's index of documents start..start + rows."""
        fields = row_fields(part, rows)
        if self.first is None:
            self.first = part
            self.arrays = {k: _empty_like(v, self.n) for k, v in fields.items()}
        for k, v in fields.items():
            self.arrays[k][start:start + rows] = v

    def finish(self):
        """The first chunk's index with every row field of the whole corpus."""
        return _with(self.first, self.arrays)


def held_bytes(index, n: int) -> Dict[str, int]:
    """Bytes of the index's row fields on a device and in host memory."""
    held = {"device": 0, "host": 0}
    for v in row_fields(index, n).values():
        if isinstance(v, np.ndarray):
            held["host"] += v.nbytes
        else:
            held["device" if v.device.type != "cpu" else "host"] += v.numel() * v.element_size()
    return held


def rows_differ(index, n: int, part, start: int, rows: int, device) -> torch.Tensor:
    """[rows] bool on ``device``: documents start..start + rows whose row in
    ``index`` (of ``n`` documents) differs, in any field, from the same row
    of ``part``, an index of only those documents. Rows are compared bit for
    bit, on ``device`` (host fields are copied there)."""
    want, have = row_fields(part, rows), row_fields(index, n)
    differ = torch.zeros(rows, dtype=torch.bool, device=device)
    for k, w in want.items():
        w, g = _bytes(w, rows, device), _bytes(have[k][start:start + rows], rows, device)
        differ |= (w != g).any(1)
    return differ


def _bytes(a, rows: int, device) -> torch.Tensor:
    """[rows, row bytes] uint8 on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    return t.to(device).contiguous().view(torch.uint8).reshape(rows, -1)
