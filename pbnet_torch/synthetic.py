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
  scene (``__graft_entry__.py:8-96``);
* :func:`bench_train_batch` — the bench scene with the labels a train step
  reads (``bench.py:361-371``), and :class:`SyntheticDataset`, a tiny
  in-memory dataset with the JAX package's training interface;
* :func:`write_scannet_scene` — a room-like triangulated mesh written in
  ScanNet's file layout, for the data path (decode -> Dataset -> evaluate).

Everything is numpy, made from ``np.random.RandomState`` seeds.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .config import StaticShapes
from .core.quantize import sparse_quantize_np
from .data.ply import write_ply_mesh
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


def bench_train_batch(seed: int = 0, shapes: StaticShapes = BENCH_SHAPES,
                      augment_seed: int | None = None):
    """(numpy batch, oracle (sem_pred_p, offset_pred_p, sem_soft_p)) of the
    bench scene for a train step: ``bench_batch`` plus ``sem_label`` and
    ``ins_label`` (-100 in the padding and, for instances, at floor and
    wall), ``inst_info`` with each instance point's object center in
    columns 0:3 (-100 elsewhere) and ``instance_pointnum``.  With
    ``augment_seed`` the scene is first flipped and rotated by
    ``augment.data_augment`` (``RandomState(augment_seed)``), the object
    centers with it; rotated, the scene takes 2-14% more voxels per level
    (``BENCH_SHAPES.scaled(1.25)`` holds it)."""
    rng = np.random.RandomState(seed)
    xyz, sem, ins, centers = make_scene(rng)
    if augment_seed is not None:
        from .data import augment

        both, _, _ = augment.data_augment(np.concatenate([xyz, centers]), np.zeros(3), None, 0,
                                          np.random.RandomState(augment_seed), flip=True,
                                          rot=True)
        both = both.astype(np.float32)
        xyz, centers = both[: len(xyz)], both[len(xyz):]
    batch = bench_batch(rng, xyz, shapes)
    n, P = xyz.shape[0], shapes.point_cap
    has_ins = ins >= 0
    info = np.full((P, 9), -100.0, np.float32)
    info[:n][has_ins, 0:3] = centers[ins[has_ins]]
    pointnum = np.zeros(shapes.instance_cap, np.int32)
    pointnum[: ins.max() + 1] = np.bincount(ins[has_ins])
    batch.update(sem_label=_pad(sem.astype(np.int32), P, -100),
                 ins_label=_pad(ins.astype(np.int32), P, -100),
                 inst_info=info, instance_pointnum=pointnum)
    return batch, oracle_stage1(xyz, sem, ins, centers, P)


class SyntheticDataset:
    """``n_scenes`` tiny two-instance scenes (``synthetic_batch``) in memory,
    with the training interface of the JAX package's ``Dataset``: one scene
    per batch, a seeded shuffle per epoch."""

    def __init__(self, shapes: StaticShapes = GRAFT_SHAPES, n_scenes: int = 2,
                 seed: int = 0, manual_seed: int = 22):
        rng = np.random.RandomState(seed)
        self.scenes = [synthetic_batch(shapes, rng) for _ in range(n_scenes)]
        self.train_file_list = [f"synthetic{i:04d}" for i in range(n_scenes)]
        self.manual_seed = manual_seed

    def train_epoch_ids(self, epoch: int, rank: int = 0, world: int = 1):
        order = np.random.RandomState(self.manual_seed + epoch).permutation(len(self.scenes))
        return [order[i:i + 1] for i in range(len(order))][rank::world]

    def train_batch(self, ids) -> dict:
        if len(ids) != 1:
            raise ValueError("SyntheticDataset batches hold one scene")
        return dict(self.scenes[int(ids[0])])

    def train_loader(self, epoch: int, rank: int = 0, world: int = 1, picks=None):
        batches = self.train_epoch_ids(epoch, rank, world)
        for i in range(len(batches)) if picks is None else picks:
            yield self.train_batch(batches[i])


def _grid_patch(origin, u, v, nu: int, nv: int):
    """A triangulated nu x nv vertex grid spanning ``origin + [0,1]u +
    [0,1]v``: (vertices (nu*nv, 3), faces (2(nu-1)(nv-1), 3))."""
    a, b = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="ij")
    xyz = (np.asarray(origin, np.float64) + a.reshape(-1, 1) * np.asarray(u, np.float64)
           + b.reshape(-1, 1) * np.asarray(v, np.float64))
    i, j = np.meshgrid(np.arange(nu - 1), np.arange(nv - 1), indexing="ij")
    q = (i * nv + j).ravel()
    faces = np.concatenate([np.stack([q, q + nv, q + 1], 1),
                            np.stack([q + 1, q + nv, q + nv + 1], 1)])
    return xyz, faces


# NYU40 ids of the object classes write_scannet_scene draws from (cabinet,
# bed, chair, sofa, table, bookshelf, counter, desk)
OBJECT_NYU40 = (3, 4, 5, 6, 7, 10, 12, 14)


def write_scannet_scene(root, name: str, rng, n_vertices: int, n_objects: int = 8,
                        spacing: float = 0.01, wall_height: float = 1.2,
                        object_labels=OBJECT_NYU40) -> int:
    """Write a room-like triangulated mesh in ScanNet's file layout under
    ``root``: ``<name>_vh_clean_2.ply``, ``.labels.ply`` (NYU40 ids),
    ``_vh_clean_2.0.010000.segs.json`` and ``.aggregation.json``.

    A square floor (NYU40 2) and two walls (NYU40 1) sized so that the mesh
    holds about ``n_vertices`` vertices at ``spacing`` (about 1 cm: a 2 cm
    voxel then holds several vertices, about 0.25 voxels per vertex), and
    ``n_objects`` open boxes (four sides and a top, 14-20 cm on a side:
    1,100-2,200 vertices each) standing 6 cm above the floor, so that no
    object touches the floor or another within the 4 cm clustering radius;
    labels cycle through ``object_labels``.  Floor and walls are dark and
    objects bright (red 35-45 against 215-255, which ``color_oracle``
    reads).  The
    over-segmentation cuts every flat face into 0.2 m tiles; each object is
    one aggregation group of its tiles.  Returns the vertex count."""
    os.makedirs(root, exist_ok=True)
    sizes = 0.14 + 0.06 * rng.rand(n_objects, 3)
    obj_area = float((2 * sizes[:, 2] * (sizes[:, 0] + sizes[:, 1]) + sizes[:, 0] * sizes[:, 1]).sum())
    # floor L^2 + walls 2 L h + objects = n_vertices * spacing^2
    area = n_vertices * spacing ** 2 - obj_area
    if area <= 0:
        raise ValueError(f"{n_vertices} vertices cannot hold {n_objects} objects")
    L = -wall_height + (wall_height ** 2 + area) ** 0.5
    cols = int(np.ceil(np.sqrt(n_objects)))
    cell = L / cols
    if sizes[:, :2].max() + 0.1 > cell:
        raise ValueError(f"a {L:.2f} m room is too small for {n_objects} objects")

    verts, faces, labels, segs, groups = [], [], [], [], []
    seg_base = 0

    def add(origin, u, v, label, obj=None):
        nonlocal seg_base
        nu = max(2, int(round(np.linalg.norm(u) / spacing)) + 1)
        nv = max(2, int(round(np.linalg.norm(v) / spacing)) + 1)
        xyz, f = _grid_patch(origin, u, v, nu, nv)
        a, b = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
        tiles_v = -(-nv // 20)
        tile = (a.ravel() // 20) * tiles_v + b.ravel() // 20
        n0 = sum(len(x) for x in verts)
        verts.append(xyz)
        faces.append(f + n0)
        labels.append(np.full(len(xyz), label, np.uint16))
        segs.append(seg_base + tile)
        if obj is not None:
            groups[obj]["segments"] += [int(t) for t in np.unique(seg_base + tile)]
        seg_base += int(tile.max()) + 1

    h = wall_height
    add((0, 0, 0), (L, 0, 0), (0, L, 0), 2)
    add((0, 0, 0), (L, 0, 0), (0, 0, h), 1)
    add((0, 0, 0), (0, L, 0), (0, 0, h), 1)
    for i, (sx, sy, sz) in enumerate(sizes):
        label = int(object_labels[i % len(object_labels)])
        groups.append({"id": i, "objectId": i, "label": f"object{label}", "segments": []})
        cx = (i % cols + 0.5) * cell + (rng.rand() - 0.5) * (cell - sx - 0.1)
        cy = (i // cols + 0.5) * cell + (rng.rand() - 0.5) * (cell - sy - 0.1)
        x0, y0, z0 = cx - sx / 2, cy - sy / 2, 0.06
        add((x0, y0, z0 + sz), (sx, 0, 0), (0, sy, 0), label, i)
        add((x0, y0, z0), (sx, 0, 0), (0, 0, sz), label, i)
        add((x0, y0 + sy, z0), (sx, 0, 0), (0, 0, sz), label, i)
        add((x0, y0, z0), (0, sy, 0), (0, 0, sz), label, i)
        add((x0 + sx, y0, z0), (0, sy, 0), (0, 0, sz), label, i)
    xyz = np.concatenate(verts).astype(np.float32)
    xyz += (rng.randn(*xyz.shape) * 0.001).astype(np.float32)
    faces = np.concatenate(faces)
    labels = np.concatenate(labels)
    seg = np.concatenate(segs)
    shade = np.where(labels[:, None] <= 2, 40, 220 + 4 * (labels[:, None] % 8))
    rgb = np.clip(shade + rng.randint(-5, 6, (len(xyz), 3)), 0, 255).astype(np.uint8)

    base = os.path.join(root, name)
    write_ply_mesh(base + "_vh_clean_2.ply", xyz, rgb, faces)
    write_ply_mesh(base + "_vh_clean_2.labels.ply", xyz, rgb, faces, labels)
    with open(base + "_vh_clean_2.0.010000.segs.json", "w") as f:
        json.dump({"sceneId": name, "segIndices": seg.tolist()}, f)
    with open(base + ".aggregation.json", "w") as f:
        json.dump({"sceneId": name, "segGroups": groups}, f)
    return len(xyz)


def _identity_norm(bn) -> None:
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)
    bn.weight.data.fill_(1.0)
    bn.bias.data.zero_()


def _pass_through(unet, pairs) -> None:
    """Set ``unet``'s weights (in place) so that its output channel ``o`` is
    relu(input channel ``i``) at every voxel, for each ``(i, o)`` of
    ``pairs``, and 0 in every other channel: the stem copies the inputs at
    its centre offset, the last decoder stage's blocks pass only the stem's
    skip through (their conv branches scaled to zero) and the final layer
    is the identity on the stem's channels."""
    from .nn.minkunet import MinkUNetBase

    width = unet.conv0.kernel.shape[2]  # the stem's width: the skip concatenated last
    k = unet.conv0.kernel
    k.zero_()
    for i, o in pairs:
        k[k.shape[0] // 2, i, o] = 1.0  # the centre offset of the k=5 stem
    _identity_norm(unet.bn0)
    last = 8 if isinstance(unet, MinkUNetBase) else 2
    for b in range(unet.layers[-1]):
        blk = getattr(unet, f"block{last}_{b}")
        blk.norm2.weight.zero_()
        blk.norm2.bias.zero_()
        if blk.downsample_conv is not None:
            w = blk.downsample_conv.weight
            w.zero_()
            for c in range(width):
                w[c, w.shape[1] - width + c] = 1.0
            _identity_norm(blk.downsample_norm)
    unet.final.weight.zero_()
    unet.final.bias.zero_()
    for c in range(width):
        unet.final.weight[c, c] = 1.0


def _read_channel0(head, out: int, gain: float, cut: float) -> None:
    """An MLP head whose output ``out`` is ``gain * x0 - cut`` for a
    non-negative input channel 0, every other output 0."""
    head.linear1.weight.zero_()
    head.linear1.weight[0, 0] = 1.0
    _identity_norm(head.norm)
    head.linear2.weight.zero_()
    head.linear2.bias.zero_()
    head.linear2.weight[out, 0] = gain
    head.linear2.bias[out] = -cut


def color_oracle(model, sem_class: int, gain: float = 20.0, cut: float = 3.0,
                 lift: float = 20.0) -> None:
    """Set a few of ``model``'s weights (in place) so that, on scenes from
    :func:`write_scannet_scene`, stage 1 predicts ``sem_class`` on the bright
    objects and class 0 on the dark floor and walls, with zero offsets;
    stage 2 keeps the points of each proposal's own cluster and drops those
    of its neighbour clusters; stage 3 scores every proposal near 1.

    The rest of the weights stay as they were (random).  The backbone
    passes the red channel through (``_pass_through``) and the semantic
    head turns it into the logit ``gain * relu(red) - cut`` for
    ``sem_class`` (0 for every other class); the offset head is zeroed.  The
    D_Unet passes the local scene's weight channel (1 on the own cluster's
    points, at most 0.5 on a neighbour's) and the mask head's logit is
    ``2 * gain * (weight - 0.75)``; the IoU head's output bias is raised by
    ``lift``.  Random weights alone predict no class on enough points to
    cluster, a semantic head biased to one class makes floor and walls
    foreground too (which overflows the clustering band and the local-scene
    budget at ScanNet scale), and a mask head that keeps every local-scene
    point merges each proposal with its neighbours."""
    import torch

    with torch.no_grad():
        _pass_through(model.MEUnet, [(c, c) for c in range(model.MEUnet.conv0.kernel.shape[1])])
        _read_channel0(model.linear_sem, sem_class, gain, cut)
        model.linear_offset.linear2.weight.zero_()
        model.linear_offset.linear2.bias.zero_()
        # the local scene's features are [32 point features | class score | weight]
        _pass_through(model.D_Unet, [(model.D_Unet.conv0.kernel.shape[1] - 1, 0)])
        _read_channel0(model.linear_binary, 0, 2 * gain, 1.5 * gain)
        model.linear_IOU.linear2.bias += lift
