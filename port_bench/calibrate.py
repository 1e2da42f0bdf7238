"""Readings for the check's limits: the program and its control, each
against the plain reference, at a cell's own size, one line per seed.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 [--control float8]

For each seed: the cell's set-up, one request of every room of the pool
through the port (as the window sends them), the reference's outputs, and
the control's: the reference put in the program's place with its conv
operands rounded to ``--control`` (float8: e4m3, one scale per tensor, the
step below the configuration's bfloat16).  Each line holds each number's
worst over the rooms for the program and for the control.  The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, eval_cell, spec, train_cell, weights


def train_readings(cell, seed: int, device, control: str,
                   ranks: train_cell.Ranks = train_cell.SOLO) -> dict:
    """The program's, the control's and each planted fault's readings of a
    training cell's check steps (on this rank)."""
    from .tests.faults import ExchangeLeftOut, HalfBatchLeftOut

    n = cell.traffic["check_steps"]
    prog, batches, wts, first, _ = train_cell.first_steps(cell, seed, device, ranks=ranks)
    del prog
    got = [("program", first), ("control", None)]
    faults = [("half_batch_left_out", HalfBatchLeftOut())]
    if ranks.world > 1:
        faults.append(("exchange_left_out", ExchangeLeftOut()))
    for name, fault in faults:
        run = train_cell.first_steps(cell, seed, device, fault, ranks)
        got.append((name, run[3]))
        del run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = train_cell.reference_steps(cell, batches, wts, device, n, ranks=ranks)
    same = train_cell.reference_steps(cell, batches, wts, device, n,
                                      cell.config["conv_operands"], ranks)
    ctl = train_cell.reference_steps(cell, batches, wts, device, n, operands=control,
                                     ranks=ranks)
    got[1] = ("control", ctl)
    out = {"seed": seed}
    for name, reading in got:
        out[name] = train_cell.compare(reading, ref, same)
        out[name + "_not_judged"] = train_cell.uncompared(reading, ref, same)
    out["where"] = {"program": train_cell.diagnose(first, ref),
                    "control": train_cell.diagnose(ctl, ref)}
    return out


def readings(cell, seed: int, device, control: str) -> dict:
    pool = cell.make_pool(cell.traffic, seed)
    wts = weights.make(cell.config, seed, device)
    prog = eval_cell.Program(cell, pool, wts, device)
    got = {i: prog(i)[0] for i in range(len(pool))}
    del prog
    torch.cuda.empty_cache()
    rooms = list(range(len(pool)))
    ref, _ = eval_cell.reference_outputs(cell, pool, wts, device, rooms)
    ctl, _ = eval_cell.reference_outputs(cell, pool, wts, device, rooms, operands=control)
    return {"seed": seed,
            "program": check.worst({i: check.compare(got[i], ref[i]) for i in rooms}),
            "control": check.worst({i: check.compare(ctl[i], ref[i]) for i in rooms})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", default="float8")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(args.workload)
    if cell.chips > 1:
        from . import ranks

        for s in args.seeds.split(","):
            t0 = time.perf_counter()
            r = ranks.launch(args.workload, int(s), 0.0, False, cell.chips, job="calibrate",
                             limit_s=900)
            r["seconds"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
        return 0
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        fn = train_readings if cell.traffic["kind"] == "train" else readings
        r = fn(cell, int(s), torch.device("cuda", 0), args.control)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
