"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file, and a traffic mix, ``traffic/<name>.json``.
The configuration's ``index`` key names its kind: ``indexes/<kind>.py``
(the port's side) and ``reference/<kind>.py`` (the plain reference). A
metric is ``metrics/<name>.py`` with ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    return load_json(path)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise ValueError(f"no workload {name!r}; known: {[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(CHECKOUT / c["file"])
    raise ValueError(f"no configuration {name!r}; known: {[c['name'] for c in bench['configs']]}")


def traffic(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise ValueError(f"no traffic mix {name!r} ({path} is missing)")
    return load_json(path)


def index_kind(kind: str) -> ModuleType:
    """The port's side of an index kind (imports the port)."""
    return _module("indexes", kind)


def reference_kind(kind: str) -> ModuleType:
    """The plain reference of an index kind."""
    return _module("reference", kind)


def _module(package: str, name: str) -> ModuleType:
    if not (HERE / package / f"{name}.py").is_file():
        raise ValueError(f"no {package}/{name}.py")
    return importlib.import_module(f"bench_port.{package}.{name}")


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py`` (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no reader for metric {name!r} ({path} is missing)")
    module_name = "bench_port.metrics." + re.sub(r"[^0-9A-Za-z_]", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[Dict]:
    """The metric entries a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)]
