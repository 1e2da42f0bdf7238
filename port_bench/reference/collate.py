"""The reference's own batch: a scene's copies quantized at 2 cm, stacked
and padded to the smallest size bucket that holds them (a frozen copy of
the port's ``StaticShapes.scaled`` and of the val collate's bucket rule,
``pbnet_torch/config.py`` and ``pbnet_torch/data/dataset.py``, keeping
only what the forward reads)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .core.quantize import sparse_quantize_np


@dataclass(frozen=True)
class Caps:
    """Static capacities of one size bucket (the fields of the port's
    ``StaticShapes`` that the plain forward reads)."""

    point_cap: int
    voxel_caps: Tuple[int, ...]
    cluster_cap: int
    local_point_cap: int
    local_voxel_caps: Tuple[int, ...]
    score_voxel_caps: Tuple[int, ...]
    instance_cap: int
    cluster_band: int
    fg_point_cap: Optional[int] = None
    nn_exact_cap: Optional[int] = None
    grid_extent: Optional[Tuple[int, int, int, int]] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Caps":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})

    def scaled(self, f: float) -> "Caps":
        """Every point and voxel capacity scaled by ``f`` and rounded up; the
        grid extent's X/Y by ``sqrt(f)``."""
        if f == 1.0:
            return self

        def r(x, q):
            return max(q, -int(-x * f // q) * q)

        ext = self.grid_extent
        if ext is not None:
            s = f ** 0.5
            ext = (ext[0],) + tuple(max(64, -int(-d * s // 32) * 32) for d in ext[1:3]) \
                + (ext[3],)
        return dataclasses.replace(
            self,
            point_cap=r(self.point_cap, 4096),
            voxel_caps=tuple(r(v, 512) for v in self.voxel_caps),
            local_point_cap=r(self.local_point_cap, 4096),
            local_voxel_caps=tuple(r(v, 512) for v in self.local_voxel_caps),
            score_voxel_caps=tuple(r(v, 512) for v in self.score_voxel_caps),
            fg_point_cap=r(self.fg_point_cap, 4096) if self.fg_point_cap else None,
            grid_extent=ext,
        )


def buckets(caps: Caps, scales) -> list:
    return [caps.scaled(f) for f in sorted(set(scales))]


def collate(copies, feats: np.ndarray, n_instances: int, bucket_list,
            voxel_size: float, device) -> tuple[dict, Caps]:
    """(batch tensors on ``device``, bucket) of one scene's ``copies``
    (each (n, 3) xyz) with per-point ``feats`` (n, 6)."""
    coords, vfeats, xs, pb = [], [], [], []
    for bi, xyz in enumerate(copies):
        vox, index, _ = sparse_quantize_np(xyz, voxel_size)
        coords.append(np.concatenate([np.full((vox.shape[0], 1), bi, np.int32), vox], 1))
        vfeats.append(feats[index])
        xs.append(xyz.astype(np.float32))
        pb.append(np.full(xyz.shape[0], bi, np.int32))
    coords = np.concatenate(coords)
    n_pts, n_vox = sum(x.shape[0] for x in xs), coords.shape[0]
    vmax = coords[:, 1:].max(0) + 1
    sh = bucket_list[-1]
    for b in bucket_list:
        ext_ok = b.grid_extent is None or all(int(vmax[i]) <= b.grid_extent[1 + i]
                                              for i in range(3))
        if (n_pts <= b.point_cap and n_vox <= b.voxel_caps[0]
                and n_instances <= b.instance_cap and ext_ok):
            sh = b
            break
    P, V = sh.point_cap, sh.voxel_caps[0]
    if n_pts > P or n_vox > V:
        raise ValueError(f"scene exceeds the caps: points {n_pts}/{P}, voxels {n_vox}/{V}")

    def pad(a, cap):
        out = np.zeros((cap,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return torch.from_numpy(out).to(device)

    batch = {
        "vox_coords": pad(coords, V),
        "vox_feats": pad(np.concatenate(vfeats).astype(np.float32), V),
        "vox_valid": torch.arange(V, device=device) < n_vox,
        "xyz": pad(np.concatenate(xs), P),
        "point_batch": pad(np.concatenate(pb), P),
        "point_valid": torch.arange(P, device=device) < n_pts,
    }
    return batch, sh


def instance_info(xyz: np.ndarray, ins: np.ndarray):
    """Per-point instance (mean, min, max) and per-instance sizes (PBNet
    dataset_preprocess.py:146-173)."""
    info = np.full((xyz.shape[0], 9), -100.0, np.float32)
    pointnum = []
    n_inst = int(ins.max()) + 1
    for i in range(n_inst):
        idx = np.where(ins == i)[0]
        pointnum.append(len(idx))
        if len(idx):
            pts = xyz[idx]
            info[idx, 0:3] = pts.mean(0)
            info[idx, 3:6] = pts.min(0)
            info[idx, 6:9] = pts.max(0)
    return n_inst, info, pointnum


def collate_train(scenes, caps: Caps, voxel_size: float, device) -> dict:
    """The reference's training batch: ``scenes`` a list of (xyz (n, 3),
    feats (n, 6), sem (n,), ins (n,)), quantized, stacked with instance
    ids made distinct, and padded to ``caps``."""
    coords, vfeats, xs, pb, sems, inss, infos, pointnum = [], [], [], [], [], [], [], []
    total = 0
    for bi, (xyz, feats, sem, ins) in enumerate(scenes):
        vox, index, _ = sparse_quantize_np(xyz, voxel_size)
        coords.append(np.concatenate([np.full((vox.shape[0], 1), bi, np.int32), vox], 1))
        vfeats.append(feats[index])
        x32 = xyz.astype(np.float32)
        xs.append(x32)
        pb.append(np.full(xyz.shape[0], bi, np.int32))
        sems.append(sem.astype(np.int32))
        n_inst, info, pn = instance_info(x32, ins.astype(np.int32))
        ins = ins.astype(np.int32).copy()
        ins[ins != -100] += total
        total += n_inst
        inss.append(ins)
        infos.append(info)
        pointnum.extend(pn)
    P, V, I = caps.point_cap, caps.voxel_caps[0], caps.instance_cap

    def pad(a, cap, fill=0):
        out = np.full((cap,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return torch.from_numpy(out).to(device)

    coords = np.concatenate(coords)
    n_pts, n_vox = sum(x.shape[0] for x in xs), coords.shape[0]
    if n_pts > P or n_vox > V or total > I:
        raise ValueError(f"batch exceeds the caps: points {n_pts}/{P}, voxels {n_vox}/{V}, "
                         f"instances {total}/{I}")
    return {
        "vox_coords": pad(coords, V),
        "vox_feats": pad(np.concatenate(vfeats).astype(np.float32), V),
        "vox_valid": torch.arange(V, device=device) < n_vox,
        "xyz": pad(np.concatenate(xs), P),
        "point_batch": pad(np.concatenate(pb), P),
        "point_valid": torch.arange(P, device=device) < n_pts,
        "sem_label": pad(np.concatenate(sems), P, -100),
        "ins_label": pad(np.concatenate(inss), P, -100),
        "inst_info": pad(np.concatenate(infos), P, -100.0),
        "instance_pointnum": pad(np.asarray(pointnum, np.int32), I),
    }
