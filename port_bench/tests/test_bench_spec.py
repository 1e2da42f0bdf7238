"""BENCHMARK.json against the contract's character rules, and every file
found by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from port_bench import harness, spec
from port_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


def test_names_and_units_use_allowed_characters():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] \
        + [c["name"] for c in BENCH["configs"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for group in (metrics, BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] \
            + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_is_found_by_name():
    for c in BENCH["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert set(cell.limits) and cell.traffic["kind"] in harness.KINDS
        for m in cell.metrics:
            assert callable(spec.reader(m["name"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        mv = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mv.get("workloads", m["workloads"]))


def test_a_cell_added_as_files_runs_through_the_dry_path(tmp_path):
    base = tmp_path / "bench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    traffic = tiny.eval_cell().traffic
    (base / "traffic" / "eval-tiny.json").write_text(json.dumps(traffic))
    limits = spec.load_json(spec.HERE / "limits" / "pbnet34c.eval-tta.json")
    (base / "limits" / "pbnet34c.eval-tiny.json").write_text(json.dumps(limits))
    (base / "metrics" / "requests_done.py").write_text(
        "def read(rec):\n    w = rec.get('window')\n    return len(w['latency_s']) if w else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "pbnet34c.eval-tiny", "config": "pbnet-34c",
                               "traffic": "eval-tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "request",
                               "moves": "scenes_per_s", "workloads": ["pbnet34c.eval-tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("scenes_per_s", "scene_ms_p90"):
            m["workloads"].append("pbnet34c.eval-tiny")
    cell = spec.cell("pbnet34c.eval-tiny", bench, base)
    assert [m["name"] for m in cell.metrics if m["end_to_end"]] == \
        ["scenes_per_s", "scene_ms_p90", "setup_s"]
    line = harness.run_cell(cell, 2**33 + 5, 0.5, False, torch.device("cpu"), base=base)
    assert line["attempted"] >= 1 and line["failed"] == 0 and line["correct"]
    assert set(line["metrics"]) == {"scenes_per_s", "scene_ms_p90", "setup_s"}
    per_layer = spec.read_metrics([m for m in cell.metrics if not m["end_to_end"]],
                                  {"window": {"latency_s": [0.1, 0.2]}}, base)
    assert per_layer == {"requests_done": {"value": 2.0, "unit": "requests"}}
    assert list(line)[-1] == "check"


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(entry):
    cell = spec.cell(entry["name"])
    e2e = [m["name"] for m in cell.metrics if m["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(not m["end_to_end"] for m in cell.metrics)
