"""Host-side augmentation, crop and instance bookkeeping (port of
pbnet_tpu/data/augment.py).

Numpy version of PBNet datasets/scannetv2/dataset_preprocess.py:79-195 with
identical semantics (including the deterministic eval rotation
theta = 0.35*pi + i*2*pi/3 used to match the published checkpoints,
:89-93).  The RNG draws come in the JAX package's order with its dtypes, so
the same seed gives the same batches bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.interpolate
import scipy.ndimage


def data_augment(xyz, rgb, nl, i, rng: np.random.RandomState, *,
                 jitter=False, flip=False, rot=False, scale=False,
                 elastic_dist=False, prob=1.0):
    m = np.eye(3)
    if jitter and rng.rand() < prob:
        m += rng.randn(3, 3) * 0.1
    if flip and rng.rand() < prob:
        m[0][0] *= rng.randint(0, 2) * 2 - 1
    if rot and rng.rand() < prob:
        theta = rng.rand() * 2 * math.pi
        m = np.matmul(m, rot_z(theta))
    else:
        # deterministic TTA rotation (dataset_preprocess.py:89-93)
        theta = 0.35 * math.pi + math.pi * i * (2 / 3)
        m = np.matmul(m, rot_z(theta))
    xyz = np.matmul(xyz, m)
    xyz = xyz - xyz.min(0)

    if scale and rng.rand() < prob:
        xyz = xyz * rng.uniform(0.95, 1.05)

    if elastic_dist and rng.rand() < prob:
        xyz = elastic(xyz, 6, 40, rng)
        xyz = elastic(xyz, 20, 160, rng)
        xyz = xyz - xyz.min(0)

    rgb = rgb + rng.randn(3) * 0.1
    return xyz, rgb, nl


def rot_z(theta: float) -> np.ndarray:
    return np.array(
        [[math.cos(theta), math.sin(theta), 0],
         [-math.sin(theta), math.cos(theta), 0],
         [0, 0, 1]]
    )


def elastic(x, gran, mag, rng: np.random.RandomState):
    """Elastic distortion via tri-directionally blurred noise grids
    (dataset_preprocess.py:176-195)."""
    blurs = [
        np.ones((3, 1, 1), np.float32) / 3,
        np.ones((1, 3, 1), np.float32) / 3,
        np.ones((1, 1, 3), np.float32) / 3,
    ]
    bb = np.abs(x).max(0).astype(np.int32) // gran + 3
    noise = [rng.randn(bb[0], bb[1], bb[2]).astype(np.float32) for _ in range(3)]
    for _ in range(2):
        for blur in blurs:
            noise = [
                scipy.ndimage.convolve(n, blur, mode="constant", cval=0)
                for n in noise
            ]
    ax = [np.linspace(-(b - 1) * gran, (b - 1) * gran, b) for b in bb]
    interp = [
        scipy.interpolate.RegularGridInterpolator(ax, n, bounds_error=False, fill_value=0)
        for n in noise
    ]
    g = np.hstack([itp(x)[:, None] for itp in interp])
    return x + g * mag


def crop(xyz, max_crop_p, full_scale, scale_size, rng: np.random.RandomState):
    """Shrinking-window random crop (dataset_preprocess.py:111-127)."""
    xyz_offset = xyz.copy()
    valid = xyz_offset.min(1) >= 0
    fs = np.array([full_scale] * 3, np.float64)
    room_range = xyz.max(0) - xyz.min(0)
    while valid.sum() > max_crop_p:
        offset = np.clip(fs - room_range + 0.001, None, 0) * rng.rand(3)
        xyz_offset = xyz + offset
        valid = (xyz_offset.min(1) >= 0) & ((xyz_offset < fs).sum(1) == 3)
        fs[:2] -= 32 * scale_size / 50.0
    return xyz_offset, valid


def compact_instance_labels(ins, valid=None):
    """Re-pack instance ids to a dense range after a crop
    (dataset_preprocess.py:129-144)."""
    if valid is not None:
        ins = ins[valid]
    ins = ins.copy()
    j = 0
    while j < ins.max():
        if (ins == j).sum() == 0:
            ins[ins == ins.max()] = j
        j += 1
    return ins


def instance_info(xyz, ins):
    """Per-point instance (mean,min,max) + per-instance sizes
    (dataset_preprocess.py:146-173)."""
    info = np.full((xyz.shape[0], 9), -100.0, np.float32)
    pointnum = []
    n_inst = int(ins.max()) + 1
    for i in range(n_inst):
        idx = np.where(ins == i)[0]
        if len(idx) == 0:
            pointnum.append(0)
            continue
        pts = xyz[idx]
        info[idx, 0:3] = pts.mean(0)
        info[idx, 3:6] = pts.min(0)
        info[idx, 6:9] = pts.max(0)
        pointnum.append(len(idx))
    return n_inst, info, pointnum
