"""``BENCHMARK.json`` and the files the harness finds by name.

* ``configs/<config>.json``: a configuration as it is run; its ``archs``
  (architecture name -> spec) state the UNets the reference builds;
* ``reference/backbones/<family>.py``: a backbone family, which builds the
  architectures whose spec names it as ``family`` (the contract is in
  ``reference/backbones/__init__.py``);
* ``traffic/<traffic>.json``: a traffic mix's parameters, read by the
  general generator (``rooms.py``) unless ``traffic/<traffic>.py`` brings a
  ``make_pool(params, seed)`` of its own;
* ``limits/<workload>.json``: each number the check compares and its limit;
* ``metrics/<metric>.py``: one reader, ``read(record) -> float | None``.

A cell, a configuration, a backbone family or a metric is added by adding
files and entries.
"""

from __future__ import annotations

import importlib
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
    with its files read from ``base`` (its backbone families too: the
    configuration's ``backbones_dir``)."""
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
    config.setdefault("backbones_dir", str(base / "reference" / "backbones"))
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [dict(m, end_to_end=True) for m in e2e]
                + [dict(m, end_to_end=False) for m in per_layer], make_pool)


BACKBONES = HERE / "reference" / "backbones"
_FAMILY_COPIES: dict[Path, object] = {}


def family(name: str, where: str | Path | None = None):
    """The module of backbone family ``name``: ``<where>/<name>.py``, by
    default ``reference/backbones/<name>.py`` of this package.  A file of
    the package is imported as its submodule; one elsewhere (a copy of the
    package) is loaded once per path under a name of its own."""
    path = (Path(where or BACKBONES) / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"backbone family {name!r}: no file {path}")
    if path.parent == BACKBONES.resolve():
        return importlib.import_module(f"{__package__}.reference.backbones.{name}")
    if path not in _FAMILY_COPIES:
        _FAMILY_COPIES[path] = load_module(path, f"port_bench_backbone_{name}")
    return _FAMILY_COPIES[path]


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
