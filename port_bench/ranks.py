"""The launcher of a cell on several cards: one process per card, one
data-parallel rank each.

``launch`` takes a rendezvous port from the OS, spawns ``world`` ranks that
all run the same seeded traffic, collects each rank's result, and joins
every rank (or ends it) within the run's own limit.  Rank 0's result line
is the run's, with the peak memory of the fullest card and the device busy
time averaged over the cards.  The program's ranks join one process group
(NCCL on cards, gloo on the CPU); the reference's join a gloo group beside
it.
"""

from __future__ import annotations

import queue
import socket
import sys
import time
import traceback

LIMIT_S = 330  # every rank joined or ended within the run's 360 s


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, workload: str, seed: int, seconds: float,
              trace: bool, device_type: str, out, bench=None, base=None, fault=None,
              job: str = "run"):
    """One rank: its process groups, its card, its share of the run (or,
    with ``job="calibrate"``, of ``calibrate.train_readings``)."""
    try:
        import torch
        import torch.distributed as dist

        from . import harness, spec
        from .train_cell import Ranks

        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        ref_group = dist.new_group(backend="gloo")
        cell = spec.cell(workload, bench, base or spec.HERE)
        ranks = Ranks(dist.group.WORLD, ref_group, rank, world)
        if job == "calibrate":
            from . import calibrate

            line = calibrate.train_readings(cell, seed, device, "float8", ranks)
        else:
            line = harness.run_cell(cell, seed, seconds, trace, device, fault=fault,
                                    base=base or spec.HERE, ranks=ranks)
        dist.barrier(group=ref_group)
        dist.destroy_process_group()
        out.put((rank, "ok", line))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise


def launch(workload: str, seed: int, seconds: float, trace: bool, world: int,
           device_type: str = "cuda", bench=None, base=None, fault=None,
           limit_s: float = LIMIT_S, job: str = "run") -> dict:
    """Run ``workload`` on ``world`` ranks; returns rank 0's result line
    (with ``job="calibrate"``, rank 0's readings)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, daemon=True,
                         args=(r, world, port, workload, seed, seconds, trace, device_type,
                               out, bench, base, fault, job)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit_s
    results, errors = {}, {}
    try:
        while len(results) + len(errors) < world and time.monotonic() < deadline:
            try:
                rank, status, payload = out.get(timeout=2)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and out.empty():
                    break
                continue
            (results if status == "ok" else errors)[rank] = payload
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if errors or len(results) < world:
        for r, tb in sorted(errors.items()):
            print(f"[rank {r}] {tb}", file=sys.stderr)
        raise RuntimeError(f"{world - len(results)} of {world} ranks gave no result "
                           f"(exit codes {[p.exitcode for p in procs]})")
    line = results[0]
    if job != "run":
        return line
    dev = line["device"]
    dev["memory_peak_bytes"] = max(r["device"]["memory_peak_bytes"] for r in results.values())
    if trace:
        dev["busy_s"] = sum(r["device"]["busy_s"] for r in results.values()) / world
    line["correct"] = all(r["correct"] for r in results.values())
    # the check key stays last
    line["check"] = line.pop("check")
    return line
