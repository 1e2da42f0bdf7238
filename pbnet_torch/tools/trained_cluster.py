"""Clustering on trained content (port of perf/trained_cluster_r5.py).

The bench drives the instance stage with oracle semantics and offsets
(tight blobs: one propagation round, almost no 1-NN rows).  A trained
model's offsets are noisier, which can need more label-propagation rounds
(B2) and send more unassigned rows to the banded 1-NN (B4).  This tool fits
the model on the bench scene with the backbone losses only (semantic CE,
offset L1 and direction; Adam at lr 1e-3, no weight decay), then times
``binary_cluster`` on the predicted semantics and offsets at two stages of
training, ``EARLY_STEPS`` (noisy) and ``EARLY_STEPS + LATE_STEPS``
(converged), against the oracle content.

At each content it prints the clustering time (CUDA events, median of 10
calls after 2 warm-ups; host clock on the CPU), ``num_clusters``,
``prop_rounds``, ``band_overflow``, the semantic accuracy and the offset
MAE, the B4 needy rows and the B1-B4 launches of one call (the launch
counters).  The last stdout line is one JSON object of these readings.

    python -m pbnet_torch.tools.trained_cluster [--device cpu] [--out DIR]

``--out DIR`` saves each content's ``sem`` and ``offs`` to
``DIR/<content>.npz`` (padded to the point cap).  Runs on CUDA unless
``--device cpu`` is passed (at the bench scene the CPU run takes tens of
GB); without a GPU it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from .. import resolve_device, synthetic
from ..config import Config, StaticShapes
from ..models.pbnet import COUNT_MEAN, PBNet, batch_to_device
from ..ops import cluster as cl
from ..ops import window_kernels as wk
from ..parallel.train_step import make_optimizer, make_train_step

# the script's capacities (perf/trained_cluster_r5.py:33-45)
SHAPES = StaticShapes(
    point_cap=147_456,
    voxel_caps=(98_304, 45_056, 16_384, 6_144, 2_048),
    cluster_cap=128,
    local_point_cap=61_440,
    local_voxel_caps=(45_056, 22_528, 9_216, 4_608, 2_048),
    score_voxel_caps=(45_056, 22_528, 9_216, 4_608, 2_048),
    instance_cap=128,
    cluster_band=4_096,
    fg_point_cap=61_440,
    nn_exact_cap=1_024,
    grid_extent=(1, 256, 256, 160),
)
SCENE: dict = {}  # synthetic.make_scene's keyword arguments (its defaults)
RADIUS, MIN_PTS = 0.04, 31
LR = 1e-3
EARLY_STEPS, LATE_STEPS = 40, 240
WARMUP, REPS = 2, 10
CLUSTER_KERNELS = ("neighbor_pack", "masked_window_reduce", "masked_window_border", "window_1nn")


def bench_content(shapes: StaticShapes = SHAPES, scene: dict | None = None):
    """(numpy batch with the backbone's labels, oracle sem (P,), oracle
    offsets (P, 3), ground-truth sem (n,), n) of the bench scene
    (``synthetic.make_scene`` of ``RandomState(0)``, its keyword arguments
    from ``scene``), built as the script builds it: instance points carry
    their object centre in ``inst_info[:, 0:3]``, other rows 0 there."""
    rng = np.random.RandomState(0)
    xyz, sem_gt, ins_gt, centers = synthetic.make_scene(rng, **(scene or {}))
    batch = synthetic.bench_batch(rng, xyz, shapes)
    n, P = xyz.shape[0], shapes.point_cap
    sem_o = synthetic._pad(sem_gt.astype(np.int32), P, -1)
    # object centres rounded to f32 before the subtraction, as the script
    has_ins = ins_gt >= 0
    center_of = np.zeros((P, 3), np.float32)
    center_of[:n][has_ins] = centers[ins_gt[has_ins]]
    offs_o = np.zeros((P, 3), np.float32)
    offs_o[:n][has_ins] = center_of[:n][has_ins] - xyz[has_ins]
    info = np.full((P, 9), -100.0, np.float32)
    info[:n, 0:3] = center_of[:n]
    pointnum = np.zeros(shapes.instance_cap, np.int32)
    pointnum[: ins_gt.max() + 1] = np.bincount(ins_gt[has_ins])
    batch.update(sem_label=synthetic._pad(sem_gt.astype(np.int32), P, -100),
                 ins_label=synthetic._pad(ins_gt.astype(np.int32), P, -100),
                 inst_info=info, instance_pointnum=pointnum)
    return batch, sem_o, offs_o, sem_gt, n


def compact(sem, offs, xyz, n: int, shapes: StaticShapes = SHAPES):
    """The script's fg compaction: the classes whose point count reaches
    ``0.05 * COUNT_MEAN``, ``sem >= 2``, the fg rows first (stable) up to
    ``fg_point_cap``.  ``sem`` (P,) int32, ``offs`` and ``xyz`` (P, 3) f32,
    the first ``n`` rows valid.  Returns ``binary_cluster``'s positional
    arguments (shifted, orig, sem, batch, valid)."""
    P, dev = sem.shape[0], sem.device
    nf = shapes.fg_point_cap or P
    cm = torch.as_tensor(COUNT_MEAN, device=dev)
    sem_clip = torch.clamp(sem, 0, 19)
    ok = torch.arange(P, device=dev) < n
    class_count = torch.bincount(torch.where(ok, sem_clip, 20).long(), minlength=21)[:20]
    class_ok = class_count.to(torch.float32) >= torch.tensor(0.05, device=dev) * cm
    fg = ok & (sem >= 2) & class_ok[sem_clip.long()]
    sel = torch.sort(torch.where(fg, 0, 1).to(torch.int32), stable=True).indices[:nf]
    return ((xyz + offs)[sel], xyz[sel], sem[sel],
            torch.zeros(sel.shape[0], dtype=torch.int32, device=dev), fg[sel])


def cluster_kw(shapes: StaticShapes, device) -> dict:
    """``binary_cluster``'s keyword arguments of the script."""
    return dict(radius=RADIUS, min_pts=MIN_PTS,
                count_mean=torch.as_tensor(COUNT_MEAN, device=device),
                cluster_cap=shapes.cluster_cap, band=shapes.cluster_band,
                nn_exact_cap=shapes.nn_exact_cap)


def cluster_on(sem, offs, xyz, n: int, shapes: StaticShapes = SHAPES) -> cl.ClusterResult:
    """``binary_cluster`` (radius 0.04, ``min_pts`` 31, the script's caps)
    on the fg compaction of the given content."""
    return cl.binary_cluster(*compact(sem, offs, xyz, n, shapes),
                             **cluster_kw(shapes, sem.device))


def time_ms(fn, cuda: bool) -> float:
    """Median ms of ``REPS`` calls of ``fn`` after ``WARMUP`` (CUDA events
    on the card, the host clock on the CPU)."""
    for _ in range(WARMUP):
        fn()
    ts = []
    for _ in range(REPS):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def reading(sem, offs, xyz, n, shapes, sem_gt, offs_o, cuda: bool) -> dict:
    """One content's readings: one counted call (its B4 needy rows from
    the kernel's row mask, its launches from the counters), then the timing."""
    args = compact(sem, offs, xyz, n, shapes)
    kw = cluster_kw(shapes, sem.device)
    needy, b4 = [], wk.window_1nn

    def b4_counted(*a):
        needy.append(int(a[2].sum()))
        return b4(*a)

    before = dict(wk.LAUNCHES)
    wk.window_1nn = b4_counted
    try:
        res = cl.binary_cluster(*args, **kw)
    finally:
        wk.window_1nn = b4
    launches = {k: wk.LAUNCHES[k] - before[k] for k in CLUSTER_KERNELS}
    ms = time_ms(lambda: cl.binary_cluster(*args, **kw), cuda)
    sem_np = sem[:n].cpu().numpy()
    return dict(ms=ms, num_clusters=int(res.num_clusters), prop_rounds=int(res.prop_rounds),
                band_overflow=int(res.band_overflow), nn_overflow=int(res.nn_overflow),
                fg_rows=int(args[4].sum()), sem_acc=float((sem_np == sem_gt).mean()),
                offset_mae=float(np.abs(offs[:n].cpu().numpy() - offs_o[:n]).mean()),
                needy_rows=sum(needy), launches=launches)


def run(device=None, out: str | None = None) -> dict:
    """Train, predict and time as the module docstring says, at ``SHAPES``,
    ``SCENE``, ``EARLY_STEPS`` and ``LATE_STEPS`` (read when called);
    returns the readings."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t0 = time.time()
    shapes = SHAPES
    batch_np, sem_o, offs_o, sem_gt, n = bench_content(shapes, SCENE)
    batch = batch_to_device(batch_np, dev)
    xyz = batch["xyz"]
    model = PBNet(shapes, seed=0, device=dev)
    cfg = Config()  # Adam, lr 1e-3, fg/bg thresholds 0.95 / 0.2
    opt = make_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg, with_instances=False)
    print(f"scene: {n} points, {int(batch_np['vox_valid'].sum())} voxels; setup "
          f"{time.time() - t0:.1f} s", flush=True)

    out_readings = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
                    "points": n, "contents": {}, "train": {}}

    def measure(label, sem, offs):
        r = reading(sem, offs, xyz, n, shapes, sem_gt, offs_o, cuda)
        out_readings["contents"][label] = r
        print(f"cluster[{label}]: {r['ms']:.3f} ms  clusters={r['num_clusters']} "
              f"prop_rounds={r['prop_rounds']} band_overflow={r['band_overflow']} "
              f"nn_overflow={r['nn_overflow']} sem_acc={r['sem_acc']:.3f} "
              f"offset_mae={r['offset_mae']:.4f} fg_rows={r['fg_rows']} "
              f"b4_needy_rows={r['needy_rows']} launches={r['launches']}", flush=True)
        if out:
            os.makedirs(out, exist_ok=True)
            np.savez(os.path.join(out, f"{label}.npz"), sem=sem.cpu().numpy(),
                     offs=offs.cpu().numpy())

    measure("oracle", torch.from_numpy(sem_o).to(dev), torch.from_numpy(offs_o).to(dev))
    total = 0
    for label, steps in (("early", EARLY_STEPS), ("late", LATE_STEPS)):
        t1 = time.time()
        losses = [float(step(batch, LR)["loss"]) for _ in range(steps)]
        secs = time.time() - t1
        total += steps
        out_readings["train"][label] = dict(steps=steps, total_steps=total, s=secs,
                                            ms_per_step=secs / steps * 1e3,
                                            loss_first=losses[0], loss_last=losses[-1])
        print(f"trained {total} steps ({secs:.1f} s, {secs / steps * 1e3:.1f} ms/step): loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}", flush=True)
        model.eval()
        with torch.no_grad():
            bb = model.backbone(batch)
        model.train()
        measure(label, bb["sem_pred_p"], bb["offset_pred_p"].contiguous())
    out_readings["seconds"] = time.time() - t0
    return out_readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pbnet_torch.tools.trained_cluster",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    p.add_argument("--out", default=None, help="directory for each content's sem and offsets")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run(dev, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
