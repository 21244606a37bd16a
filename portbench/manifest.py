"""Finds a cell's pieces by the names in ``BENCHMARK.json``, so that a
configuration, a traffic mix, a cell or a per-layer metric is added by adding
files (and entries), never by editing one:

- ``BENCHMARK.json``: the cell (its configuration and traffic by name), the
  configuration's file, the end-to-end and per-layer metrics;
- ``traffic/<traffic>.json``: the mix's parameters (``traffic.py`` reads them);
- ``cells/<cell>.json``: what the check samples and the limits of each
  number it compares, and the stretch of the window that a traced run
  profiles;
- ``metrics/<metric>.py``: one reader per per-layer metric, a function
  ``read(record) -> float | None`` over the traced run's record
  (``run.py``); None when it finds nothing to read.  A metric split by the
  end-to-end metric it moves (``step_busy_ms.p99`` beside ``step_busy_ms``)
  shares the reader of the name before its first dot, unless it has its own.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration's file
    traffic: dict       # traffic/<traffic>.json
    plan: dict          # cells/<cell>.json
    end_to_end: list    # BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict       # per-layer metric name -> read(record)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(path: str) -> Callable:
    name = "portbench_metric_" + os.path.basename(path)[:-3].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reader_path(bench: str, metric: str) -> str:
    """``metrics/<metric>.py``, else ``metrics/<metric up to its first dot>.py``."""
    own = os.path.join(bench, "metrics", metric + ".py")
    if os.path.exists(own):
        return own
    return os.path.join(bench, "metrics", metric.split(".")[0] + ".py")


def _reports(entry: dict, cell: str, moves: set = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return moves is None or entry["moves"] in moves


def cell(name: str, root: str = ROOT, bench: str = HERE) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json, its files under ``bench``."""
    m = _json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in m["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in m["configs"] if c["name"] == w["config"]][0]
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    moves = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"] if _reports(x, name, moves)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(os.path.join(root, conf["file"])),
                traffic=_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
                plan=_json(os.path.join(bench, "cells", name + ".json")),
                end_to_end=e2e, per_layer=per_layer,
                readers={x["name"]: _reader(reader_path(bench, x["name"]))
                         for x in per_layer})
