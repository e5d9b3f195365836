"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/``), traffic mix (``traffic/``), parameters and
limits (``cells/<workload>.json``), driver (``drivers/<name>.py``),
per-layer readers (``metrics/<metric>.py``) and counters
(``counters/<name>.py``).  No list of them lives in code."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    params: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict[str, Any], workload: str, reported_e2e=None) -> bool:
    """A metric with a ``workloads`` list belongs to those cells; an
    end-to-end one without it to every cell; a per-layer one without it to
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if reported_e2e is None:
        return True
    return metric["moves"] in reported_e2e


def load_cell(root: str, workload: str, here: str = HERE) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"bench_port: no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf_entry["file"]))
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    params = _json(os.path.join(here, "cells", workload + ".json"))
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, params, e2e, per_layer)


def load_module(kind: str, name: str, here: str = HERE):
    """``<here>/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(here, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_port_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise SystemExit(f"bench_port: no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
