"""Overfit-to-AP proof of training (port of tests/overfit_worker.py).

Trains the full three-stage pipeline (backbone -> offsets -> clustering ->
D_Unet masks -> ScoreNet) on two fabricated scenes until the instance AP@25
of ``engine.evaluate`` is high: the proof that training learns, not only
runs.  Semantics and offsets must drive clustering, masks must fit the
instances, scores must follow IoU, and the AP protocol must see the result.

The scenes are learnable by a convolution net: a floor plane plus three box
"chairs" whose class is coded in colour and local geometry.

* Memorised (default): train on the exact batches ``evaluate`` sees, each
  val batch holding the scene's three deterministic TTA rotations (offset
  vectors are view-specific: convs are not rotation-equivariant).  Target
  AP25 >= 0.9.
* ``heldout``: train on fresh batches of two copies with a random
  z-rotation at every step (the production augmentation), then evaluate on
  the TTA views, rotations the net never exactly saw.  Target AP25 >= 0.5.

Schedule: ``bb_steps`` backbone-only steps, then up to ``rounds`` rounds of
``full_steps`` full steps, each round followed by ``engine.evaluate``;
stops at the first round that reaches the target.  Adam at lr 1e-3.

    python -m pbnet_torch.tools.overfit OUTDIR [--heldout] [--device cpu]

writes ``OUTDIR/result.json`` (the worker's keys, plus ``ap25_by_round``
and ``seconds`` per phase) and prints it as the last stdout line.  Runs on
CUDA unless ``--device cpu`` is passed; without a GPU it raises.
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

from .. import engine, resolve_device
from ..bench import launches
from ..config import Config, StaticShapes
from ..data import augment
from ..data.dataset import Dataset
from ..data.decode_scannet import write_val_gt
from ..parallel.train_step import make_optimizer, make_train_step

FLOOR_SEM = 1  # nyu40 "floor" -> semantic index 1
CHAIR_SEM = 4  # nyu40 "chair" -> semantic index 4 (instance class)
LR = 1e-3

# level caps do not shrink 2x per stride for these dense box surfaces, so
# they stay generous (overflow at any level degrades clustering)
SHAPES = StaticShapes(
    point_cap=4096, voxel_caps=(4096, 4096, 2048, 1024, 512),
    cluster_cap=16, local_point_cap=8192,
    local_voxel_caps=(8192, 8192, 4096, 2048, 1024),
    score_voxel_caps=(8192, 8192, 4096, 2048, 1024),
    instance_cap=16, cluster_band=1024,
)


def config(outdir: str) -> Config:
    """The worker's config over the fabricated data at ``outdir``."""
    return Config(
        data_root=outdir, batch_size=1, max_crop_p=4000, min_crop_p=10,
        num_works=0, cache=False, shapes=SHAPES, mixup=False,
        cluster_epoch=-1, validation=False, logpath=os.path.join(outdir, "log"),
    )


def box_surface(rng, center, size, n):
    """n points on the surface of an axis-aligned box + outward normals."""
    pts = np.empty((n, 3))
    nrm = np.zeros((n, 3))
    face = rng.randint(0, 6, n)
    uv = rng.rand(n, 2) - 0.5
    for f in range(6):
        m = face == f
        ax, sign = f // 2, 1.0 if f % 2 == 0 else -1.0
        o1, o2 = [a for a in range(3) if a != ax]
        pts[m, ax] = sign * 0.5
        pts[m, o1] = uv[m, 0]
        pts[m, o2] = uv[m, 1]
        nrm[m, ax] = sign
    return center + pts * size, nrm


def fabricate_npy_scene(npy_dir, name, rng, n_floor=500, n_chair=260):
    """Floor plane + 3 box chairs, class-coded colours; write the npy set."""
    os.makedirs(npy_dir, exist_ok=True)
    # floor: 2m x 2m plane at z ~ 0
    fx = rng.rand(n_floor, 2) * 2.0
    floor = np.concatenate([fx, rng.randn(n_floor, 1) * 0.003], 1)
    parts_xyz = [floor]
    parts_nl = [np.tile([0.0, 0.0, 1.0], (n_floor, 1))]
    parts_rgb = [np.tile([-0.5, -0.5, -0.4], (n_floor, 1)) + rng.randn(n_floor, 3) * 0.05]
    parts_sem = [np.full(n_floor, FLOOR_SEM, np.float64)]
    parts_ins = [np.full(n_floor, -100.0)]
    sup = [np.arange(n_floor) // 50]  # floor superpoint blocks
    next_sup = int(sup[0].max()) + 1
    centers = [(0.5, 0.5), (1.5, 0.55), (1.0, 1.55)]
    for i, (cx, cy) in enumerate(centers):
        p, nl = box_surface(rng, np.array([cx, cy, 0.2]), 0.3, n_chair)
        parts_xyz.append(p)
        parts_nl.append(nl)
        parts_rgb.append(np.tile([0.8, -0.3, -0.3], (n_chair, 1)) + rng.randn(n_chair, 3) * 0.05)
        parts_sem.append(np.full(n_chair, CHAIR_SEM, np.float64))
        parts_ins.append(np.full(n_chair, float(i)))
        sup.append(np.full(n_chair, next_sup + i))
    pre = os.path.join(npy_dir, name)
    np.save(pre + "_xyz.npy", np.concatenate(parts_xyz))
    np.save(pre + "_rgb.npy", np.concatenate(parts_rgb))
    np.save(pre + "_nl.npy", np.concatenate(parts_nl))
    np.save(pre + "_sem_label.npy", np.concatenate(parts_sem))
    np.save(pre + "_ins_label.npy", np.concatenate(parts_ins))
    np.save(pre + "_sup.npy", np.concatenate(sup).astype(np.int64))


def fabricate(outdir: str) -> list[str]:
    """The two scenes (``RandomState(0)``), the split lists and the val GT
    files under ``outdir``; returns the scene names."""
    rng = np.random.RandomState(0)
    npy = os.path.join(outdir, "npy")
    names = []
    for i in range(2):
        nm = f"scene{i:04d}_00"
        fabricate_npy_scene(npy, nm, rng)
        names.append(nm)
    np.savetxt(os.path.join(outdir, "scannetv2_train.txt"), names, fmt="%s")
    np.savetxt(os.path.join(outdir, "scannetv2_val.txt"), names, fmt="%s")
    np.savetxt(os.path.join(outdir, "scannetv2_test.txt"), names[:1], fmt="%s")
    write_val_gt(npy, names, os.path.join(outdir, "val_gt"))
    return names


def view_batch(ds, idx, views, full_bucket=False, rot_rng=None):
    """A collated batch of the scene rendered at the given TTA view indices
    (as ``Dataset.val_batch``, which uses views (0, 1, 2)).  ``full_bucket``
    pads to ``cfg.shapes`` (the train step's shapes).  With ``rot_rng`` each
    copy gets a random z-rotation (the production train augmentation)
    instead of the deterministic TTA angle."""
    fn = ds.val_file_list[idx]
    s = ds._load_scene(fn, with_sup=True)
    s, keep, orig_n = ds._fit_eval_scene(s)
    rng = rot_rng if rot_rng is not None else np.random.RandomState(0)
    scenes = []
    for i in views:
        xyz, rgb, nl = augment.data_augment(
            s["xyz"].copy(), s["rgb"].copy(), s["nl"], i, rng, rot=rot_rng is not None)
        ins = augment.compact_instance_labels(s["ins"].copy())
        scenes.append((fn, xyz, rgb, nl, s["sem"].copy(), ins))
    batch = ds._collate(scenes, buckets=None if full_bucket else ds.cfg.eval_buckets())
    batch["sup"] = s["sup"]
    batch["fn"] = fn
    batch["keep_idx"] = keep
    batch["orig_num_points"] = orig_n
    batch["dropped_sem"] = None
    return batch


def timed_step(step, batch):
    """(aux as floats, milliseconds, kernel launches) of one train step; the
    clock stops after the aux values reach the host."""
    before = launches()
    t0 = time.perf_counter()
    aux = step(batch, LR)
    keys = sorted(aux)
    vals = torch.stack([aux[k].detach().float() for k in keys]).tolist()
    ms = (time.perf_counter() - t0) * 1e3
    after = launches()
    return dict(zip(keys, vals)), ms, {k: after[k] - before[k] for k in after}


def run(outdir: str, heldout: bool = False, device=None, bb_steps: int = 150,
        full_steps: int = 40, rounds: int = 3, record: dict | None = None) -> dict:
    """Fabricate the scenes under ``outdir``, train and evaluate as the
    module docstring says, write ``outdir/result.json`` and return it.

    ``record`` (a dict to fill) gets ``bb_step_ms`` and ``full_step_ms``
    (every step), ``full_step_launches`` and ``full_step_overflow`` (each
    full step's kernel launches and overflow counters) and ``evaluations``:
    per round, ``engine.evaluate``'s timing (per-scene launches and
    overflow) and the cumulative launch counters before and after it."""
    dev = resolve_device(device)
    rec = {} if record is None else record
    seconds = {}
    t0 = time.time()
    fabricate(outdir)
    cfg = config(outdir)
    ds = Dataset(cfg)
    model = engine.build_model(cfg, dev)
    aug_rng = np.random.RandomState(7)
    batches = []
    if not heldout:
        # the exact batches evaluate() sees, which must sit in the full
        # bucket (== cfg.shapes) to match the training model's shapes
        raw = [ds.val_batch(i) for i in range(2)]
        if any(b.get("shapes", cfg.shapes) != cfg.shapes for b in raw):
            raise ValueError(f"val batches outside the full bucket: "
                             f"{[b.get('shapes', cfg.shapes).point_cap for b in raw]}")
        batches = [engine.device_batch(b, dev) for b in raw]
    opt = make_optimizer(model, cfg)
    seconds["setup"] = time.time() - t0

    def train_batch(it):
        if heldout:  # fresh random rotation every step
            return engine.device_batch(
                view_batch(ds, it % 2, (0, 1), full_bucket=True, rot_rng=aug_rng), dev)
        return batches[it % 2]

    step_bb = make_train_step(model, opt, cfg, with_instances=False)
    step_full = make_train_step(model, opt, cfg, with_instances=True)

    # phase 1: backbone-only steps until semantics and offsets lock in
    t0 = time.time()
    rec["bb_step_ms"] = []
    for it in range(bb_steps):
        aux, ms, _ = timed_step(step_bb, train_batch(it))
        rec["bb_step_ms"].append(ms)
        if it % 25 == 24:
            print(f"bb step {it + 1}: sem={aux['semantic_loss']:.4f} "
                  f"off={aux['offset_norm_loss']:.4f} ({time.time() - t0:.0f}s)", flush=True)
    sem_loss_after_bb = aux["semantic_loss"]
    seconds["backbone"] = time.time() - t0

    # phase 2: the full pipeline; mask and score losses must trend down
    hist = {"mask_loss": [], "score_loss": [], "loss": [], "semantic_loss": []}
    ap_target = 0.5 if heldout else 0.9
    result, ap25_by_round = {}, []
    rec.update(full_step_ms=[], full_step_launches=[], full_step_overflow=[], evaluations=[])
    seconds.update(full=0.0, evaluate=0.0)
    for round_i in range(rounds):
        t1 = time.time()
        for it in range(full_steps):
            aux, ms, n = timed_step(step_full, train_batch(it))
            rec["full_step_ms"].append(ms)
            rec["full_step_launches"].append(n)
            rec["full_step_overflow"].append({k: v for k, v in aux.items()
                                              if k.startswith("overflow")})
            for k in hist:
                hist[k].append(aux[k])
            if it % 10 == 9:
                print(f"full step {it + 1}: sem={hist['semantic_loss'][-1]:.4f} "
                      f"mask={hist['mask_loss'][-1]:.4f} "
                      f"score={hist['score_loss'][-1]:.4f} ({time.time() - t0:.0f}s)",
                      flush=True)
        t2 = time.time()
        timing, before = {}, launches()
        res = engine.evaluate(cfg, model, ds, epoch=1, timing=timing)
        rec["evaluations"].append(dict(timing=timing, launches_before=before,
                                       launches_after=launches()))
        seconds["full"] += t2 - t1
        seconds["evaluate"] += time.time() - t2
        ap25 = float(res.get("AP25", 0.0))
        ap25_by_round.append(ap25)
        result = dict(res)
        print(f"round {round_i}: AP25={ap25:.3f} ({time.time() - t0:.0f}s)", flush=True)
        if ap25 >= ap_target:
            break
    result["sem_loss_final"] = float(np.mean(hist["semantic_loss"][-5:]))
    result.update(
        sem_loss_after_bb=sem_loss_after_bb,
        mask_loss_first=float(np.mean(hist["mask_loss"][:5])),
        mask_loss_last=float(np.mean(hist["mask_loss"][-5:])),
        score_loss_first=float(np.mean(hist["score_loss"][:5])),
        score_loss_last=float(np.mean(hist["score_loss"][-5:])),
        steps_full=len(hist["loss"]),
        ap25_by_round=ap25_by_round,
        seconds=seconds,
    )
    with open(os.path.join(outdir, "result.json"), "w") as f:
        json.dump(result, f)
    for k in ("bb_step_ms", "full_step_ms"):
        if rec[k]:
            print(f"{k} median {statistics.median(rec[k]):.3f}", flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pbnet_torch.tools.overfit",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("outdir", help="directory for the fabricated data, the log and result.json")
    p.add_argument("--heldout", action="store_true",
                   help="train on random rotations, evaluate on the TTA views (target 0.5)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' for the plain path)")
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    result = run(args.outdir, heldout=args.heldout, device=args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
