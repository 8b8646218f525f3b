"""An index put together a chunk at a time from the port's build holds what
the port's build of the whole corpus holds, field by field; and the check's
row comparison finds a changed row in any field."""

import numpy as np
import pytest
import torch

from bench_port.tests._tiny import CELLS, tiny_config
from bench_port import assemble, spec


def _codes(cfg, n=3000):
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, 2 ** cfg["n_levels"], (n, cfg["code_dim"]), dtype=torch.int8,
                         generator=g)


def _assembled(cfg, kind, codes, chunk):
    rows = assemble.Rows(codes.shape[0])
    starts = list(range(0, codes.shape[0], chunk))
    for s in reversed(starts):  # any order
        e = min(s + chunk, codes.shape[0])
        rows.add(s, e - s, kind.build(cfg, codes[s:e], "cpu"))
    return rows.finish()


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a.view(np.uint8), np.asarray(b).view(np.uint8))
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("cellname", CELLS)
def test_chunks_assemble_to_the_whole_build(cellname):
    cfg, _ = tiny_config(cellname)
    kind = spec.index_kind(cfg["index"])
    codes = _codes(cfg)
    whole = kind.build(cfg, codes, "cpu")
    got = _assembled(cfg, kind, codes, 700)
    want_f, got_f = assemble.row_fields(whole, 3000), assemble.row_fields(got, 3000)
    assert set(want_f) == set(got_f) and len(want_f) >= 2
    for k in want_f:
        assert type(got_f[k]) is type(want_f[k]) and _equal(got_f[k], want_f[k]), k
    q = codes[:16]
    ws, wi = kind.searcher(whole, cfg)(q)
    gs, gi = kind.searcher(got, cfg)(q)
    assert torch.equal(wi, gi) and torch.equal(ws, gs)
    held = assemble.held_bytes(got, 3000)
    assert held["device"] + held["host"] == sum(
        v.nbytes if isinstance(v, np.ndarray) else v.numel() * v.element_size()
        for v in got_f.values())


@pytest.mark.parametrize("cellname", CELLS)
def test_rows_differ_finds_a_changed_row_in_any_field(cellname):
    cfg, _ = tiny_config(cellname)
    kind = spec.index_kind(cfg["index"])
    codes = _codes(cfg)
    index = _assembled(cfg, kind, codes, 1000)
    part = kind.build(cfg, codes[1000:2000], "cpu")
    assert not assemble.rows_differ(index, 3000, part, 1000, 1000, "cpu").any()
    for name, field in assemble.row_fields(index, 3000).items():
        saved = field[1500].copy() if isinstance(field, np.ndarray) else field[1500].clone()
        field[1500] = field[1500] + 1 if field.dtype != torch.bool else ~field[1500]
        differ = assemble.rows_differ(index, 3000, part, 1000, 1000, "cpu")
        assert differ.sum() == 1 and differ[500], name
        field[1500] = saved
    other = kind.build(cfg, codes[:1000], "cpu")  # other documents' rows
    assert assemble.rows_differ(index, 3000, other, 1000, 1000, "cpu").float().mean() > 0.9
