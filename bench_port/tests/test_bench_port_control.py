"""The check must fail what is wrong. At a tiny size on the CPU: the
control (the reference with TF32 products in its encode in the port's
place) fails the limits, and a run with the timed path broken underneath
(an answer altered where it is produced, half of a request's queries left
out, half of the corpus left out) comes out as not correct, where the same
run unbroken is correct."""

import dataclasses
import time

import pytest
import torch

from bench_port.tests._tiny import CELLS, overrides, tiny_config
from bench_port import cell, check, spec
from bench_port.control import control_numbers

from repro_torch.index.flat import FlatSDC


@pytest.mark.parametrize("cellname", CELLS[:2])
def test_control_fails_the_limits(cellname):
    cfg, traffic = tiny_config(cellname)
    numbers = control_numbers(cfg, traffic, 77, "cpu")
    assert not check.verdict(numbers, cfg["limits"])
    # the control's codes differ, so its answers do too
    assert numbers["index_rows"] > cfg["limits"]["index_rows"]
    assert numbers["rank_gap"] > cfg["limits"]["rank_gap"]


def _half_corpus(index):
    half = lambda f: FlatSDC(codes=f.codes[: f.codes.shape[0] // 2],  # noqa: E731
                             inv_norm=f.inv_norm[: f.inv_norm.shape[0] // 2],
                             n_levels=f.n_levels, packed=f.packed)
    if isinstance(index, FlatSDC):
        return half(index)
    return dataclasses.replace(index, coarse=half(index.coarse))


def altered(search, index, cfg):
    def fn(q):
        s, ids = search(q)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % cfg["n_docs"]
        return s, ids
    return fn


def half_batch(search, index, cfg):
    def fn(q):
        n = max(1, q.shape[0] // 2)
        s, ids = search(q[:n])
        rep = torch.arange(q.shape[0]) % n
        return s[rep], ids[rep]
    return fn


def half_corpus(search, index, cfg):
    index = _half_corpus(index)
    return lambda q: index.search(q, cfg["k"])


FAULTS = {"sound": None, "answer_altered": altered, "half_batch": half_batch,
          "half_corpus": half_corpus}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cellname", CELLS[:2])
def test_a_broken_timed_path_is_not_correct(cellname, fault):
    bench = spec.benchmark()
    cfg, _ = tiny_config(cellname)
    base = spec.config(bench, spec.workload(bench, cellname)["config"])
    result = cell.run_cell(cellname, 2147483659, 0.5, False, t_start=time.perf_counter_ns(),
                           device="cpu", bench=bench, overrides=overrides(base),
                           wrap_search=FAULTS[fault])
    assert result["correct"] is (fault == "sound"), result["checks"]
    assert list(result)[-1] == "checks"
