"""``BENCHMARK.json`` and the files the harness finds by name.

* ``configs/<config>.json``: a configuration as it is run;
* ``traffic/<traffic>.json``: a traffic mix's parameters, read by the
  general generator (``rooms.py``) unless ``traffic/<traffic>.py`` brings a
  ``make_pool(params, seed)`` of its own;
* ``limits/<workload>.json``: each number the check compares and its limit;
* ``metrics/<metric>.py``: one reader, ``read(record) -> float | None``.

A cell, a configuration or a metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # the BENCHMARK.json entries this cell reports, end to end first
    make_pool: object  # (params, seed) -> rooms


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, workload: str, e2e_names_of_cell: set) -> bool:
    """Whether ``workload`` reports ``metric``: listed under its
    ``workloads``, or, without that key, any cell of an end-to-end metric
    and, for a per-layer metric, any cell that reports what it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names_of_cell


def cell(name: str, bench: dict | None = None, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: the root's BENCHMARK.json),
    with its files read from ``base``."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(base / "configs" / f"{w['config']}.json")
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    gen = base / "traffic" / f"{w['traffic']}.py"
    if gen.exists():
        make_pool = load_module(gen, f"port_bench_traffic_{w['traffic']}").make_pool
    else:
        from . import rooms
        make_pool = rooms.make_pool
    limits = load_json(base / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    config.setdefault("reduced", cfg_entry.get("reduced", []))
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [dict(m, end_to_end=True) for m in e2e]
                + [dict(m, end_to_end=False) for m in per_layer], make_pool)


def reader(metric_name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = base / "metrics" / f"{metric_name}.py"
    return load_module(path, "port_bench_metric_" + metric_name.replace(".", "_")).read


def read_metrics(entries: list, record: dict, base: Path = HERE) -> dict:
    """``{name: {"value", "unit"}}`` of every entry whose reader finds
    something in ``record``."""
    out = {}
    for m in entries:
        v = reader(m["name"], base)(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
