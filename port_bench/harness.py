"""One run of one cell, from the cell's files to the contract's result
line (``run.py`` adds the look for a card and prints it)."""

from __future__ import annotations

import sys

import torch

from . import check, eval_cell, peaks, spec, train_cell

KINDS = {"eval": eval_cell.run, "train": train_cell.run}  # traffic kind -> its cell


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             fault=None, base=spec.HERE, ranks=None) -> dict:
    """The result line of one run of ``cell`` on ``device`` (a dict); over
    data-parallel ``ranks`` (``train_cell.Ranks``), this rank's."""
    kw = {} if ranks is None else {"ranks": ranks}
    res = KINDS[cell.traffic["kind"]](cell, seed, seconds, trace, device, log, fault, **kw)
    record = res["record"]
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    record["peaks"] = peaks.of(name) if cuda else None
    entries = [m for m in cell.metrics if m["end_to_end"] != trace]
    metrics = spec.read_metrics(entries, record, base)
    numbers = res["numbers"]
    correct = (res["failed"] == 0 and res["attempted"] > 0
               and check.verdict(numbers, cell.limits))
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell.chips,
           "memory_peak_bytes": int(res["peak"])}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        t = record["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["check"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    for k, v in line["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return line
