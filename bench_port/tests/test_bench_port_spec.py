"""BENCHMARK.json and the files it names: every part loads by name, a
missing name fails, and the file keeps to the benchmark's format."""

import json
import re

import pytest

from bench_port.tests._tiny import CHECKOUT, CELLS  # noqa: F401  (sets sys.path)
from bench_port import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (CHECKOUT / p).is_dir() and not p.startswith("/") and ".." not in p
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(section):
    entries = BENCH[section]
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_parts(cell):
    w = spec.workload(BENCH, cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = spec.config(BENCH, w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert set(entry["reduced"]) == set(cfg["reduced"])
    traffic = spec.traffic(w["traffic"])
    assert traffic["clients"] >= 1 and traffic["queries_per_request"] >= 1
    spec.reference_kind(cfg["index"])
    untraced = spec.cell_metrics(BENCH, cell, trace=False)
    traced = spec.cell_metrics(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in untraced} and len(untraced) >= 2 and traced
    for m in untraced + traced:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("lookup", [
    lambda: spec.workload(BENCH, "no-such-cell"),
    lambda: spec.config(BENCH, "no-such-config"),
    lambda: spec.traffic("no-such-mix"),
    lambda: spec.metric_reader("no_such_metric"),
    lambda: spec.reference_kind("no_such_kind"),
])
def test_missing_name_fails(lookup):
    with pytest.raises(ValueError):
        lookup()
