"""An evaluation cell: rooms sent as TTA requests through the port, closed
loop, and the check of what the timed path produced.

Set-up (``setup_s``): the room pool from the seed, each room's copies
collated by the port's own val data path into the smallest of its size
buckets (``Dataset._collate`` with ``Config.eval_buckets()``), one model
per bucket in use with the benchmark's weights, and one pass over the pool
that warms every shape the window will use (the first run in a checkout
builds the port's CUDA kernels there).

A request: ``PBNet.backbone``, the oracle's semantics, offsets and softmax
in place of stage 1's predictions, ``PBNet.instance_stage``, the outputs
copied to the host (``train_step.host_outputs``) and ``eval_pipeline``'s
TTA fold, thresholds, NMS and superpoint vote down to the final instances.
CUDA events split it into stage 1 and the rest (stages 2-3 and the host
fold).

The check runs once the window has closed, the peak memory has been read
and the program's models are freed: for the last request of every room,
the plain reference (``reference/``) works the request out again from the
raw copies and the same weights, and ``check.compare`` sets what the
program produced beside it.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from . import check, spec, weights, window
from .weights import arch_kw, port_kw
from .reference import collate as ref_collate
from .reference import eval_pipeline as ref_eval
from .reference.models import pbnet as ref_pbnet
from .reference.nn import sparse_ops as ref_sparse

STAGES = (("MEUnet", "stage 1"), ("D_Unet", "stages 2-3"), ("score_Unet", "stages 2-3"))


class Thresholds:
    """The test thresholds ``eval_scene_instances`` reads."""

    def __init__(self, cfg: dict):
        self.TEST_SCORE_THRESH = cfg["TEST_SCORE_THRESH"]
        self.TEST_NPOINT_THRESH = cfg["TEST_NPOINT_THRESH"]
        self.TEST_NMS_THRESH = cfg["TEST_NMS_THRESH"]


def padded_oracle(room, point_cap: int, device):
    from . import rooms

    sem, offs, soft = rooms.oracle(room, room.copies)
    n = sem.shape[0]

    def pad(a, fill):
        out = np.full((point_cap,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    return pad(sem, -1), pad(offs, 0.0), pad(soft, 0.05)


class Program:
    """The port under test: its models per bucket, the collated requests,
    and the request itself."""

    KEYS = ("vox_coords", "vox_feats", "vox_valid", "xyz", "point_batch", "point_valid")

    def __init__(self, cell, pool, wts: dict, device):
        from pbnet_torch.config import Config, StaticShapes
        from pbnet_torch.data.dataset import Dataset
        from pbnet_torch.models.pbnet import PBNet

        cfg, tr = cell.config, cell.traffic
        caps = {k: tuple(v) if isinstance(v, list) else v for k, v in tr["caps"].items()}
        pcfg = Config(shapes=StaticShapes(**caps),
                      eval_bucket_scales=tuple(tr["bucket_scales"]),
                      voxel_size=cfg["voxel_size"], data_root=str(spec.HERE))
        ds = Dataset(pcfg)
        self.device = device
        self.thresholds = Thresholds(cfg)
        self.models, self.requests = {}, []
        for i, room in enumerate(pool):
            scenes = [(f"room{i}", xyz, room.feats[:, :3], room.feats[:, 3:], room.sem,
                       room.ins) for xyz in room.copies]
            nb = ds._collate(scenes, buckets=pcfg.eval_buckets())
            sh = nb["shapes"]
            if sh not in self.models:
                m = PBNet(sh, device=device, **port_kw(cfg))
                m.load_state_dict(wts)
                self.models[sh] = m.eval()
            batch = {k: torch.as_tensor(nb[k]).to(device) for k in self.KEYS}
            self.requests.append(dict(
                shapes=sh, batch=batch, oracle=padded_oracle(room, sh.point_cap, device),
                n_points=int(nb["num_points"]), superpoint=room.superpoint))

    def __call__(self, i: int, fault=None):
        """Request ``i`` of the pool.  Returns (outputs for the check, row)."""
        from pbnet_torch import eval_pipeline
        from pbnet_torch.parallel.train_step import host_outputs

        r = self.requests[i]
        model, batch = self.models[r["shapes"]], r["batch"]
        if fault is not None:
            batch = fault.batch(batch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if self.device.type == "cuda" else None
        if ev:
            ev[0].record()
        with record_function("request.backbone"):
            bb = model.backbone(batch)
        if ev:
            ev[1].record()
        sem_o, offs_o, soft_o = r["oracle"]
        with record_function("request.instance_stage"):
            out = model.instance_stage(
                batch, dict(bb, sem_pred_p=sem_o, offset_pred_p=offs_o, sem_soft_p=soft_o),
                with_labels=False)
        with record_function("request.host_outputs"):
            host = host_outputs(out)
        with record_function("request.eval_fold"):
            pred = eval_pipeline.eval_scene_instances(host, r["n_points"], r["superpoint"],
                                                      self.thresholds)
        if ev:
            ev[2].record()
        over = {k: int(bb[k]) for k in ("overflow_vox", "overflow_grid", "overflow_band")}
        over.update((k, int(v)) for k, v in host["overflow"].items())
        if any(over.values()):
            print(f"[request] room {i} overflows the caps: {over}", file=sys.stderr)
        outputs = check.outputs(bb, out, pred, r["n_points"])
        if fault is not None:
            outputs = fault.outputs(outputs)
        row = {"events": ev, "overflow": sum(over.values()),
               "clusters": int(out["cluster"].num_clusters)}
        return outputs, row


def stage_ms(rows) -> tuple[list, list]:
    s1 = [r["events"][0].elapsed_time(r["events"][1]) for r in rows if r["events"]]
    s23 = [r["events"][1].elapsed_time(r["events"][2]) for r in rows if r["events"]]
    return s1, s23


def reference_outputs(cell, pool, wts, device, rooms_wanted, operands="float32",
                      count=False):
    """The plain reference's outputs for each room index in
    ``rooms_wanted`` (and, with ``count``, the work of each by stage)."""
    cfg, tr = cell.config, cell.traffic
    ref_sparse.OPERANDS = operands
    caps = ref_collate.Caps.from_dict(tr["caps"])
    blist = ref_collate.buckets(caps, tr["bucket_scales"])
    model = ref_pbnet.PBNet(blist[-1], device=device, **arch_kw(cfg))
    model.load_state_dict(wts)
    model.eval()
    thresholds = Thresholds(cfg)
    res, work_of = {}, {}
    try:
        for i in rooms_wanted:
            room = pool[i]
            n_ins = int(room.ins.max()) + 1 if (room.ins >= 0).any() else 0
            batch, sh = ref_collate.collate(room.copies, room.feats, n_ins * len(room.copies),
                                            blist, cfg["voxel_size"], device)
            model.shapes = sh
            sem_o, offs_o, soft_o = padded_oracle(room, sh.point_cap, device)
            wc = None
            if count:
                from . import work

                wc = work.WorkCount(operand_bytes=check.OPERAND_BYTES[cfg["conv_operands"]])
                hooks = [getattr(model, n).register_forward_pre_hook(
                    lambda *_, s=s: setattr(wc, "stage", s)) for n, s in STAGES]
                wc.__enter__()
            try:
                bb = model.backbone(batch)
                out = model.instance_stage(
                    batch, dict(bb, sem_pred_p=sem_o, offset_pred_p=offs_o, sem_soft_p=soft_o),
                    with_labels=False)
            finally:
                if wc is not None:
                    wc.__exit__()
                    for h in hooks:
                        h.remove()
            host = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
                    for k, v in out.items() if k in check.FOLD_KEYS}
            n_points = sum(c.shape[0] for c in room.copies)
            pred = ref_eval.eval_scene_instances(host, n_points, room.superpoint, thresholds)
            res[i] = check.outputs(bb, out, pred, n_points)
            if wc is not None:
                work_of[i] = {"ops": wc.ops(), "ops_stage1": wc.ops("stage 1"),
                              "bytes_stage1": wc.bytes("stage 1")}
            del bb, out
    finally:
        ref_sparse.OPERANDS = "float32"
    return res, work_of


def run(cell, seed: int, seconds: float, trace: bool, device, log, fault=None) -> dict:
    """One run of an evaluation cell.  Returns the record the readers take
    and the check (``{"record", "check", "attempted", "failed", "peak"}``)."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    pool = cell.make_pool(cell.traffic, seed)
    wts = weights.make(cell.config, seed, device)
    prog = Program(cell, pool, wts, device)
    # one pass over the pool warms every shape the window uses
    for i in range(len(pool)):
        prog(i)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[set-up] {setup_s:.3f} s: {len(pool)} rooms, buckets "
        f"{sorted({r['shapes'].point_cap for r in prog.requests})} points")

    from . import rooms

    last, rows = {}, []
    order = rooms.send_order(len(pool), seed)

    def send(_):
        i = next(order)
        outputs, row = prog(i, fault)
        last[i] = outputs
        row["room"] = i
        rows.append(row)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    record = {"kind": "eval", "setup_s": setup_s}
    if trace:
        from . import trace as tr

        record["trace"] = tr.traced(send, len(pool))
        record["requests"] = len(rows)
    else:
        record["window"] = window.closed_loop(send, seconds)
    s1, s23 = stage_ms(rows) if cuda else ([], [])
    record["stage1_ms"], record["stages23_ms"] = s1, s23
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = sum(1 for r in rows if r["overflow"] or r["clusters"] <= 0)
    log(f"[window] {len(rows)} requests, {failed} failed; rooms sent "
        f"{np.bincount([r['room'] for r in rows], minlength=len(pool)).tolist()}")
    if not trace and s1:  # where a slow run's time went: by room, device or host
        lat = np.asarray(record["window"]["latency_s"]) * 1e3
        sent = np.asarray([r["room"] for r in rows])
        log(f"[window] median ms by room "
            f"{[round(float(np.median(lat[sent == i])), 1) for i in np.unique(sent)]}; "
            f"mean ms: stage 1 {np.mean(s1):.2f}, stages 2-3 {np.mean(s23):.2f}")
    del prog
    if cuda:
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    ref, work_of = reference_outputs(cell, pool, wts, device, sorted(last), count=trace)
    numbers = check.worst({i: check.compare(last[i], ref[i]) for i in sorted(last)})
    if len(last) < len(pool):
        numbers["rooms_unchecked"] = len(pool) - len(last)
    log(f"[check] {len(last)} rooms against the reference in {time.perf_counter() - t1:.3f} s")
    if trace:
        record["work"] = {k: sum(work_of[r["room"]][k] for r in rows)
                          for k in ("ops", "ops_stage1", "bytes_stage1")}
    return {"record": record, "numbers": numbers, "attempted": len(rows), "failed": failed,
            "peak": peak}
