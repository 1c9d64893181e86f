"""Cells by name.  ``BENCHMARK.json`` names each cell's configuration and
traffic; everything else is found by name in the benchmark's folders:

- a configuration: ``benchmark/configs/<config>.json``;
- a scene generator a configuration names: ``benchmark/generators/<name>.py``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- the loop that drives a traffic mix: ``benchmark/loops/<loop>.py``;
- a per-layer metric's reader: ``benchmark/metrics/<metric>.py``;
- a kernel's roofline count: ``benchmark/rooflines/<kernel>.py``;
- a layer's span: ``benchmark/spans/<layer>.json``;
- a cell's correctness limits: ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import functools
import glob
import importlib.util
import json
import os
from dataclasses import dataclass, field, fields

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports
    per_layer: list = field(default_factory=list)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, cell_e2e: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in cell_e2e


def find(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read;
    KeyError if there is no such cell."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    here = os.path.join(root, "benchmark")
    config = _json(os.path.join(here, "configs", w["config"] + ".json"))
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(here, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config, traffic, limits, e2e, per_layer)


def image_size(cell: Cell) -> tuple:
    """(width, height): the traffic's ``image_size``, else the
    configuration's."""
    w, h = cell.traffic.get("image_size", cell.config["image_size"])
    return int(w), int(h)


def render_params(cell: Cell, cls):
    """``cls`` (the program's ``RenderParams`` or the reference's) with
    every one of its fields that the traffic file sets, the rest at their
    defaults.  The timed loop and the comparison both build theirs here."""
    known = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in cell.traffic.items() if k in known})


@functools.cache
def load_module(kind: str, name: str, root: str = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots),
    loaded once."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spans(root: str = ROOT) -> list[dict]:
    """Every layer span, ``benchmark/spans/*.json``, in name order."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "benchmark", "spans", "*.json"))):
        spec = _json(path)
        spec.setdefault("name", os.path.basename(path)[:-5])
        out.append(spec)
    return out


def rooflines(root: str = ROOT) -> dict:
    """Every roofline count, ``benchmark/rooflines/*.py``, by kernel name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "benchmark", "rooflines", "*.py"))):
        name = os.path.basename(path)[:-3]
        out[name] = load_module("rooflines", name, root)
    return out
