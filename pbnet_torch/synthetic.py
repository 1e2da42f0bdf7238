"""Seeded synthetic scenes for the tests and the chip smoke run.

Copies from the JAX package's entry scripts (which the port does not import):

* :func:`box_surface`, :func:`make_scene` and :data:`BENCH_SHAPES` — the
  bench scene (``bench.py:43-107, 141-156``): a ~4.5 m room of floor, wall
  and 14 box-surface objects, 140k points / ~92k voxels at 2 cm;
* :data:`BANDED_SHAPES` — the bench shapes with the banded convs switched
  on (``perf/drive_r4.py:25``'s main-topology spans);
* :func:`oracle_stage1` — the bench's oracle semantics/offsets/softmax
  (``bench.py:202-210``), which drives stages 2-3 with real clusters (random
  weights predict chaotic semantics, which the class gate rejects);
* :func:`bench_batch` — the bench's padded voxel/point batch;
* :func:`synthetic_batch` and :data:`GRAFT_SHAPES` — the tiny two-instance
  scene (``__graft_entry__.py:8-96``).

Everything is numpy, made from ``np.random.RandomState`` seeds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import StaticShapes
from .core.quantize import sparse_quantize_np
from .tools.eval_protocol import SEMANTIC_LABEL_IDX

# bench.py's capacities, fitted to the bench scene (no overflow there)
BENCH_SHAPES = StaticShapes(
    point_cap=140_032,
    voxel_caps=(92_416, 39_424, 10_240, 4_096, 2_048),
    cluster_cap=16,
    local_point_cap=56_320,
    local_voxel_caps=(41_984, 20_992, 5_888, 1_536, 512),
    score_voxel_caps=(41_984, 20_992, 5_888, 1_536, 512),
    instance_cap=16,
    cluster_band=4_096,
    fg_point_cap=56_320,
    nn_exact_cap=1_024,
    grid_extent=(1, 240, 240, 136),
)

# The eval configuration with banded convs (nn/onehot_conv.py).  Main
# spans: the JAX package's own (perf/drive_r4.py:25).  Local spans: the JAX
# package has no tuned value; the spreads measured on the bench scene (local
# L1 634, down maps <= 1177, up maps <= 424 rows) fit these with room (L1
# 634 + 15 rows of alignment <= 1024; down and up maps get 2 x 1024).
# At the bench caps every banded map tiles: each cap is a multiple of
# onehot_tm = 256 and each input level holds at least one band.
BANDED_SHAPES = dataclasses.replace(
    BENCH_SHAPES,
    onehot_spans=(0, 1280, 768, 0, 0),
    onehot_spans_local=(0, 1024, 768, 0, 0),
)

# __graft_entry__._SHAPES: tiny caps for the two-instance scene
GRAFT_SHAPES = StaticShapes(
    point_cap=1024,
    voxel_caps=(512, 256, 128, 64, 32),
    cluster_cap=8,
    local_point_cap=1024,
    local_voxel_caps=(512, 256, 128, 64, 32),
    score_voxel_caps=(512, 256, 128, 64, 32),
    instance_cap=8,
    cluster_band=256,
    grid_extent=(1, 256, 256, 64),
)


def box_surface(rng, n, center, size):
    """Sample n points on the surface of an axis-aligned box."""
    sx, sy, sz = size
    areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy])
    face = rng.choice(6, n, p=areas / areas.sum())
    u, v = rng.rand(n), rng.rand(n)
    pts = np.zeros((n, 3))
    for f in range(6):
        m = face == f
        ax = f // 2
        side = f % 2
        uv_axes = [a for a in range(3) if a != ax]
        pts[m, ax] = side * size[ax]
        pts[m, uv_axes[0]] = u[m] * size[uv_axes[0]]
        pts[m, uv_axes[1]] = v[m] * size[uv_axes[1]]
    return pts - np.array(size) / 2 + np.array(center)


def make_scene(rng, n_pts=140_000, room=4.5, n_obj=14):
    """Room-like surface scene (planes/boxes + 2 mm sensor noise).

    Returns (xyz, sem, ins, centers): per-point semantic class (floor=0,
    wall=1, objects 2..19), instance id (-100 for floor/wall), and
    per-instance centers."""
    pts, sems, inss = [], [], []
    n_floor = int(n_pts * 0.35)
    pts.append(np.concatenate([rng.rand(n_floor, 2) * room, np.zeros((n_floor, 1))], 1))
    sems.append(np.zeros(n_floor, np.int32))
    inss.append(np.full(n_floor, -100, np.int32))
    n_wall = int(n_pts * 0.25)
    pts.append(np.concatenate(
        [rng.rand(n_wall, 1) * room, np.zeros((n_wall, 1)), rng.rand(n_wall, 1) * 2.5], 1))
    sems.append(np.ones(n_wall, np.int32))
    inss.append(np.full(n_wall, -100, np.int32))
    per = (n_pts - n_floor - n_wall) // n_obj
    centers = []
    for i in range(n_obj):
        c = np.array([0.4 + rng.rand() * (room - 0.8),
                      0.4 + rng.rand() * (room - 0.8),
                      0.3 + rng.rand() * 0.5])
        size = 0.3 + rng.rand(3) * 0.7
        pts.append(box_surface(rng, per, c, size))
        sems.append(np.full(per, 2 + (i % 18), np.int32))
        inss.append(np.full(per, i, np.int32))
        centers.append(c)
    xyz = np.concatenate(pts)[:n_pts]
    sem = np.concatenate(sems)[:n_pts]
    ins = np.concatenate(inss)[:n_pts]
    xyz += rng.randn(*xyz.shape) * 0.002
    shift = xyz.min(0)
    xyz -= shift
    return (xyz.astype(np.float32), sem, ins,
            np.asarray(centers, np.float32) - shift)


def _pad(a, cap, fill=0):
    out = np.full((cap,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def bench_batch(rng, xyz, shapes: StaticShapes) -> dict:
    """The bench's padded single-scene batch (voxels at 2 cm, batch id 0,
    random 6-channel voxel features from ``rng``)."""
    vox, _, _ = sparse_quantize_np(xyz, 0.02)
    n, m = xyz.shape[0], vox.shape[0]
    P, V = shapes.point_cap, shapes.voxel_caps[0]
    if n > P or m > V:
        raise ValueError(f"scene ({n} points, {m} voxels) exceeds caps ({P}, {V})")
    return {
        "vox_coords": _pad(np.concatenate([np.zeros((m, 1), np.int32), vox], 1), V),
        "vox_feats": _pad(rng.randn(m, 6).astype(np.float32) * 0.1, V),
        "vox_valid": np.arange(V) < m,
        "xyz": _pad(xyz, P),
        "point_batch": np.zeros(P, np.int32),
        "point_valid": np.arange(P) < n,
    }


def oracle_stage1(xyz, sem, ins, centers, point_cap: int):
    """Oracle (sem_pred_p, offset_pred_p, sem_soft_p) padded to point_cap:
    the true class, offsets onto the true instance center, and a softmax of
    0.9 on the true class (0.05 elsewhere)."""
    n = xyz.shape[0]
    sem_o = _pad(sem.astype(np.int32), point_cap, -1)
    has_ins = ins >= 0
    offs_o = np.zeros((point_cap, 3), np.float32)
    offs_o[:n][has_ins] = centers[ins[has_ins]] - xyz[has_ins]
    soft_o = np.full((point_cap, 20), 0.05, np.float32)
    soft_o[np.arange(point_cap), np.clip(sem_o, 0, 19)] = 0.9
    return sem_o, offs_o, soft_o


def bench_request(device, seed: int = 0, shapes: StaticShapes = BENCH_SHAPES):
    """The bench request on ``device``: (batch tensors, oracle (sem_pred_p,
    offset_pred_p, sem_soft_p) tensors, number of points).  The scene and
    the voxel features come from ``np.random.RandomState(seed)``."""
    import torch

    rng = np.random.RandomState(seed)
    xyz, sem, ins, centers = make_scene(rng)
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in bench_batch(rng, xyz, shapes).items()}
    oracle = tuple(torch.from_numpy(a).to(device)
                   for a in oracle_stage1(xyz, sem, ins, centers, shapes.point_cap))
    return batch, oracle, xyz.shape[0]


def bench_eval_inputs(seed: int = 0):
    """(gt_ids, superpoint) of the bench scene of ``bench_request(seed)``
    for the ScanNet AP evaluator (tools/eval_protocol.py).

    gt_ids: ``SEMANTIC_LABEL_IDX[sem] * 1000 + ins + 1`` at instance points
    and 0 at floor and wall, as ``get_gt_instances`` reads them.  The scene
    has no mesh to segment, so each 2 cm voxel stands in as one superpoint
    (dense ids 0..V-1).
    """
    xyz, sem, ins, _ = make_scene(np.random.RandomState(seed))
    label = np.asarray(SEMANTIC_LABEL_IDX, np.int64)[sem]
    gt_ids = np.where(ins >= 0, label * 1000 + ins + 1, 0)
    _, _, superpoint = sparse_quantize_np(xyz, 0.02)
    return gt_ids, superpoint


def synthetic_batch(shapes: StaticShapes, rng, n_pts=400, n_copies=1) -> dict:
    """Tiny scene with two instances of class 10 + floor, padded to shapes."""
    per = n_pts // 3
    blobs = [
        np.array([1.0, 1.0, 0.5]) + rng.randn(per, 3) * 0.12,
        np.array([3.0, 2.0, 0.5]) + rng.randn(per, 3) * 0.12,
        np.concatenate([rng.rand(n_pts - 2 * per, 2) * 4.0,
                        np.zeros((n_pts - 2 * per, 1))], 1),
    ]
    xyz1 = np.concatenate(blobs).astype(np.float32)
    xyz1 -= xyz1.min(0)
    sem1 = np.array([10] * per + [10] * per + [0] * (n_pts - 2 * per), np.int32)
    ins1 = np.array([0] * per + [1] * per + [-100] * (n_pts - 2 * per), np.int32)

    xyzs, sems, inss, pb = [], [], [], []
    for c in range(n_copies):
        xyzs.append(xyz1)
        sems.append(sem1)
        ins = ins1.copy()
        ins[ins != -100] += 2 * c
        inss.append(ins)
        pb.append(np.full(n_pts, c, np.int32))
    xyz = np.concatenate(xyzs)
    sem = np.concatenate(sems)
    ins = np.concatenate(inss)
    pbatch = np.concatenate(pb)
    n = xyz.shape[0]

    coords_list, feats_list = [], []
    for c in range(n_copies):
        vox, _, _ = sparse_quantize_np(xyzs[c], 0.02)
        coords_list.append(np.concatenate([np.full((vox.shape[0], 1), c, np.int32), vox], 1))
        feats_list.append(rng.randn(vox.shape[0], 6).astype(np.float32) * 0.1)
    coords = np.concatenate(coords_list)
    vfeats = np.concatenate(feats_list)

    P, V, I = shapes.point_cap, shapes.voxel_caps[0], shapes.instance_cap
    if n > P or coords.shape[0] > V:
        raise ValueError(f"scene ({n} points, {coords.shape[0]} voxels) exceeds caps")

    info = np.full((P, 9), -100.0, np.float32)
    pointnum = np.zeros(I, np.int32)
    for i in range(2 * n_copies):
        idx = np.nonzero(ins == i)[0]
        info[idx, 0:3] = xyz[idx].mean(0)
        info[idx, 3:6] = xyz[idx].min(0)
        info[idx, 6:9] = xyz[idx].max(0)
        pointnum[i] = len(idx)

    return {
        "vox_coords": _pad(coords, V, 0),
        "vox_feats": _pad(vfeats, V, 0),
        "vox_valid": np.arange(V) < coords.shape[0],
        "xyz": _pad(xyz, P, 0),
        "point_batch": _pad(pbatch, P, 0),
        "point_valid": np.arange(P) < n,
        "sem_label": _pad(sem, P, -100),
        "ins_label": _pad(ins, P, -100),
        "inst_info": info,
        "instance_pointnum": pointnum,
    }
