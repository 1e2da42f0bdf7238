"""The general traffic generator: seeded rooms, their TTA copies, the oracle
that stands in for stage 1's predictions, and the superpoints of the fold.

A room is the port's bench room (``pbnet_torch/synthetic.make_scene``,
copied here so that the yardstick stays fixed): a floor, one wall and box
surfaces, each object of its own class and instance, with 2 mm of noise.
Its side grows with the square root of its points, so every room has the
bench room's density (4.5 m at 140,000 points).

A traffic file fixes the sizes: ``points`` and ``objects`` list one room
each, so every seed serves the same set of sizes; the seed draws the
geometry, the features and the order the rooms are sent in.  Everything is
numpy from ``np.random.RandomState``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# 2**32 - 1 bounds a RandomState seed; a run's seed may be any whole number
SEED_MOD = 2**32 - 1
MAX_YZ = 1 << 20  # key stride of the voxel quantization


@dataclass
class Room:
    """One request's raw inputs: the base room and its copies."""

    xyz: np.ndarray  # (n, 3) f32 base room
    sem: np.ndarray  # (n,) int32 class (floor 0, wall 1, objects 2..19)
    ins: np.ndarray  # (n,) int32 instance, -100 on floor and wall
    feats: np.ndarray  # (n, 6) f32 point features (the colour and normal slots)
    copies: list  # TTA copies: (n, 3) f64 xyz each
    superpoint: np.ndarray  # (n,) int64 base-room 2 cm voxel of each point


def rng_for(seed: int, *salt: int) -> np.random.RandomState:
    """A RandomState for ``seed`` (any whole number) and a salt."""
    return np.random.RandomState([(int(seed) % SEED_MOD), *salt])


def box_surface(rng, n, center, size):
    """``n`` points on the surface of an axis-aligned box, faces drawn by
    area."""
    size = np.asarray(size, np.float64)
    areas = np.array([size[1] * size[2]] * 2 + [size[0] * size[2]] * 2
                     + [size[0] * size[1]] * 2)
    face = rng.choice(6, n, p=areas / areas.sum())
    uv = rng.rand(n, 2)
    ax = face // 2
    pts = np.zeros((n, 3))
    others = np.array([[1, 2], [0, 2], [0, 1]])[ax]
    rows = np.arange(n)
    pts[rows, ax] = (face % 2) * size[ax]
    pts[rows, others[:, 0]] = uv[:, 0] * size[others[:, 0]]
    pts[rows, others[:, 1]] = uv[:, 1] * size[others[:, 1]]
    return pts - size / 2 + np.asarray(center)


def make_room(rng, n_pts: int, n_obj: int, p: dict):
    """(xyz, sem, ins) of one room: floor and wall shares of ``p``, the
    rest split over ``n_obj`` boxes of class ``2 + i % 18``."""
    side = p["side_m_at_140k"] * math.sqrt(n_pts / 140_000)
    n_floor = int(n_pts * p["floor_share"])
    n_wall = int(n_pts * p["wall_share"])
    per = (n_pts - n_floor - n_wall) // n_obj
    n_pts = n_floor + n_wall + per * n_obj
    floor = np.concatenate([rng.rand(n_floor, 2) * side, np.zeros((n_floor, 1))], 1)
    wall = np.concatenate([rng.rand(n_wall, 1) * side, np.zeros((n_wall, 1)),
                           rng.rand(n_wall, 1) * p["wall_height_m"]], 1)
    objs = []
    for _ in range(n_obj):
        c = np.array([0.4 + rng.rand() * (side - 0.8), 0.4 + rng.rand() * (side - 0.8),
                      0.3 + rng.rand() * 0.5])
        objs.append(box_surface(rng, per, c, 0.3 + rng.rand(3) * 0.7))
    xyz = np.concatenate([floor, wall, *objs])
    sem = np.concatenate([np.zeros(n_floor, np.int32), np.ones(n_wall, np.int32),
                          np.repeat(2 + np.arange(n_obj, dtype=np.int32) % 18, per)])
    ins = np.concatenate([np.full(n_floor + n_wall, -100, np.int32),
                          np.repeat(np.arange(n_obj, dtype=np.int32), per)])
    xyz = xyz + rng.randn(n_pts, 3) * p["noise_m"]
    return (xyz - xyz.min(0)).astype(np.float32), sem, ins


def rot_z(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def tta_copies(xyz: np.ndarray, n: int) -> list:
    """The reference's validation copies: copy ``i`` rotated about z by
    0.35 pi + i 2 pi / 3, then shifted to the origin (valMerge,
    dataset_preprocess.py:89-93)."""
    out = []
    for i in range(n):
        c = np.matmul(xyz.astype(np.float64), rot_z(0.35 * math.pi + math.pi * i * (2 / 3)))
        out.append(c - c.min(0))
    return out


def voxel_ids(xyz: np.ndarray, voxel: float) -> np.ndarray:
    """Dense id of each point's ``voxel``-sized cell (first-seen order is not
    kept: ids follow the sorted keys)."""
    q = np.floor(xyz / voxel).astype(np.int64)
    key = (q[:, 0] * MAX_YZ + q[:, 1]) * MAX_YZ + q[:, 2]
    return np.unique(key, return_inverse=True)[1].reshape(-1)


def make_pool(p: dict, seed: int) -> list:
    """The rooms of traffic ``p`` for ``seed``, in the order of ``p``."""
    rooms = []
    for i, (n_pts, n_obj) in enumerate(zip(p["points"], p["objects"])):
        rng = rng_for(seed, i)
        xyz, sem, ins = make_room(rng, int(n_pts), int(n_obj), p)
        feats = (rng.randn(xyz.shape[0], 6) * p["feature_scale"]).astype(np.float32)
        rooms.append(Room(xyz, sem, ins, feats, tta_copies(xyz, p["tta_copies"]),
                          voxel_ids(xyz, p["voxel_m"])))
    return rooms


def send_order(n_rooms: int, seed: int):
    """Room index of each request, without end: seeded permutations of the
    pool, one after another."""
    rng = rng_for(seed, 10_007)
    while True:
        yield from (int(i) for i in rng.permutation(n_rooms))


def oracle(room: Room, copies: list):
    """Stage 1's stand-in for the points of ``copies`` in the order they are
    batched (copy after copy): the true class, the offset onto the mean of
    its instance's points in that copy (0 off instances), and a softmax of
    0.9 on the true class, 0.05 elsewhere (``synthetic.oracle_stage1``).
    Returns (sem (N,) int32, offset (N, 3) f32, soft (N, 20) f32)."""
    has = room.ins >= 0
    n_ins = int(room.ins.max()) + 1 if has.any() else 0
    cnt = np.maximum(np.bincount(room.ins[has], minlength=n_ins), 1)
    offs = []
    for xyz in copies:
        x32 = xyz.astype(np.float32)
        center = np.stack([np.bincount(room.ins[has], x32[has, a], minlength=n_ins)
                           for a in range(3)], 1) / cnt[:, None]
        o = np.zeros_like(x32)
        o[has] = center[room.ins[has]].astype(np.float32) - x32[has]
        offs.append(o)
    sem = np.tile(room.sem, len(copies)).astype(np.int32)
    soft = np.full((sem.shape[0], 20), 0.05, np.float32)
    soft[np.arange(sem.shape[0]), np.clip(sem, 0, 19)] = 0.9
    return sem, np.concatenate(offs), soft


def augment(xyz: np.ndarray, rng, flags: dict) -> np.ndarray:
    """The port's training augmentation (``data/augment.data_augment``):
    jitter, x-flip and a rotation about z, in its order of draws."""
    m = np.eye(3)
    if flags.get("jitter") and rng.rand() < 1.0:
        m += rng.randn(3, 3) * 0.1
    if flags.get("flip") and rng.rand() < 1.0:
        m[0][0] *= rng.randint(0, 2) * 2 - 1
    if flags.get("rot") and rng.rand() < 1.0:
        m = np.matmul(m, rot_z(rng.rand() * 2 * math.pi))
    out = np.matmul(xyz.astype(np.float64), m)
    return out - out.min(0)


def make_batches(p: dict, seed: int) -> list:
    """The training batches of traffic ``p`` for ``seed``: ``p["batches"]``
    batches of one room of each size in ``p["points"]``, each room drawn and
    augmented from the seed.  A batch is a list of (room, augmented xyz)."""
    out = []
    for b in range(p["batches"]):
        batch = []
        for j, (n_pts, n_obj) in enumerate(zip(p["points"], p["objects"])):
            rng = rng_for(seed, 1000 + b, j)
            xyz, sem, ins = make_room(rng, int(n_pts), int(n_obj), p)
            feats = (rng.randn(xyz.shape[0], 6) * p["feature_scale"]).astype(np.float32)
            room = Room(xyz, sem, ins, feats, [], np.zeros(0, np.int64))
            batch.append((room, augment(xyz, rng, p["augment"])))
        out.append(batch)
    return out


def batch_oracle(batch: list):
    """``oracle`` over a training batch's rooms, one after another."""
    parts = [oracle(room, [xyz]) for room, xyz in batch]
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))
