"""Sparse-tensor topology: coordinate pyramids and kernel maps (port of
pbnet_tpu/core/topology.py, lookup-based).

A ``SparseLevel`` holds the padded, key-sorted voxel coordinates at one
tensor stride.  A kernel map is an ``(M_out, K)`` int32 table: entry
``[i, k]`` is the input row that offset ``k`` of output voxel ``i`` reads, or
-1 when that input voxel does not exist.

Offsets enumerate x-major (dx slowest, dz fastest); odd k spans
``[-(k//2), k//2]``, even k spans ``[0, k)`` (MinkowskiEngine's hypercube
region), matching the ``(K, Cin, Cout)`` weight layout.

Every map here is a sorted-key lookup (``coords.lookup``).  The JAX package
builds the same maps from dense occupancy grids and, for the stage-2 local
scenes, derives them from the backbone's maps; both are exact rewrites of
this lookup (pinned equal by its own tests), so the port's maps equal the
JAX package's entry for entry and its grid overflow is 0 by construction.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from . import coords as ck
from .quantize import true_div


@dataclass
class SparseLevel:
    """Padded, key-sorted voxel set at one tensor stride."""

    coords: torch.Tensor  # (M, 4) int32 [b, x, y, z]; rows sorted by key
    hi: torch.Tensor  # (M,) int32 sorted key (pads = SENTINEL)
    lo: torch.Tensor  # (M,) int32
    valid: torch.Tensor  # (M,) bool
    count: torch.Tensor  # () int32 true number of voxels (overflow detector)
    stride: int

    @property
    def cap(self) -> int:
        return self.coords.shape[0]

    def replace(self, **kw) -> "SparseLevel":
        return dataclasses.replace(self, **kw)


def kernel_offsets(k: int) -> np.ndarray:
    """Hypercube kernel offsets, ME-compatible enumeration (x-major)."""
    r = range(-(k // 2), k // 2 + 1) if k % 2 == 1 else range(0, k)
    return np.array(
        [(dx, dy, dz) for dx in r for dy in r for dz in r], dtype=np.int32
    )


def level_from_coords(coords4, valid, cap: int, stride: int) -> SparseLevel:
    """Build a SparseLevel from (already unique) unsorted coordinates."""
    if coords4.shape[0] != cap:
        raise ValueError(f"cap mismatch: {coords4.shape[0]} rows, cap {cap}")
    hi, lo = ck.pack(coords4, valid)
    hi_s, lo_s, coords_s = ck.sort_by_key(hi, lo, coords4.to(torch.int32))
    return SparseLevel(
        coords=coords_s, hi=hi_s, lo=lo_s, valid=hi_s != ck.SENTINEL,
        count=valid.to(torch.int32).sum(dtype=torch.int32), stride=stride,
    )


def level_from_quantize(q: dict) -> SparseLevel:
    """Wrap the output of ``quantize.quantize_device`` as a stride-1
    SparseLevel."""
    return SparseLevel(
        coords=q["coords"], hi=q["hi"], lo=q["lo"], valid=q["valid"],
        count=q["count"], stride=1,
    )


def downsample(level: SparseLevel, s: int, cap: int) -> SparseLevel:
    """Coordinates of the next level: unique(floor(c/(ts*s)) * (ts*s))."""
    new_stride = level.stride * s
    c = level.coords
    dev = c.device
    down = torch.cat([c[:, :1], torch.div(c[:, 1:], new_stride, rounding_mode="floor") * new_stride], 1)
    hi, lo = ck.pack(down, level.valid)
    hi_s, lo_s, down_s = ck.sort_by_key(hi, lo, down)
    first, unique_pos, count = ck.unique_sorted(hi_s, lo_s)
    ok = first & (unique_pos < cap)
    dst = torch.where(ok, unique_pos, cap).to(torch.int64)
    sent = torch.full_like(hi_s, ck.SENTINEL)
    out_coords = torch.zeros((cap + 1, 4), dtype=torch.int32, device=dev)
    out_coords[dst] = down_s
    out_hi = torch.full((cap + 1,), ck.SENTINEL, dtype=torch.int32, device=dev)
    out_hi[dst] = torch.where(ok, hi_s, sent)
    out_lo = torch.full((cap + 1,), ck.SENTINEL, dtype=torch.int32, device=dev)
    out_lo[dst] = torch.where(ok, lo_s, sent)
    out_hi = out_hi[:cap]
    return SparseLevel(
        coords=out_coords[:cap], hi=out_hi, lo=out_lo[:cap],
        valid=out_hi != ck.SENTINEL, count=count, stride=new_stride,
    )


def lookup_offsets(out_level: SparseLevel, in_level: SparseLevel,
                   offs: np.ndarray) -> torch.Tensor:
    """(M_out, K) map: the ``in_level`` row at ``out + offs[k]``, or -1."""
    m = out_level.cap
    K = offs.shape[0]
    d4 = np.concatenate([np.zeros((K, 1), np.int32), offs.astype(np.int32)], 1)
    d4 = torch.as_tensor(d4, device=out_level.coords.device)
    q = (out_level.coords[:, None, :] + d4[None, :, :]).reshape(m * K, 4)
    # negative coordinates are simply absent (pack needs non-negatives)
    qvalid = (q[:, 1:] >= 0).all(1) & out_level.valid.repeat_interleave(K)
    qhi, qlo = ck.pack(q, qvalid)
    idx, found = ck.lookup(in_level.hi, in_level.lo, qhi, qlo)
    return torch.where(found, idx, torch.full_like(idx, -1)).reshape(m, K)


def conv_map(out_level: SparseLevel, in_level: SparseLevel, k: int) -> torch.Tensor:
    """Kernel map of a (possibly strided) convolution: the input voxel of
    output ``o`` at offset ``d`` sits at ``o + d * ts_in``."""
    return lookup_offsets(out_level, in_level, kernel_offsets(k) * in_level.stride)


def up_map_direct(fine_level: SparseLevel, coarse_level: SparseLevel) -> torch.Tensor:
    """Transposed-conv (k=2 s=2) map, coarse -> fine.

    Each fine voxel ``j`` is read by exactly one (coarse output, offset)
    pair: its parent ``floor(c_j / 2ts) * 2ts`` at offset
    ``d = (c_j - parent) / ts`` (dz-fastest index ``4dx + 2dy + dz``).  One
    lookup of the parent plus an 8-way select — the exact inverse of the
    forward strided map.
    """
    ts = fine_level.stride
    c = fine_level.coords
    parent_sp = torch.div(c[:, 1:], 2 * ts, rounding_mode="floor") * (2 * ts)
    parent = torch.cat([c[:, :1], parent_sp], 1)
    phi, plo = ck.pack(parent, fine_level.valid)
    g, found = ck.lookup(coarse_level.hi, coarse_level.lo, phi, plo)
    d = torch.div(c[:, 1:] - parent_sp, ts, rounding_mode="floor")
    kj = d[:, 0] * 4 + d[:, 1] * 2 + d[:, 2]
    k_idx = torch.arange(8, dtype=torch.int32, device=c.device)
    hit = (k_idx[None, :] == kj[:, None]) & found[:, None]
    return torch.where(hit, g[:, None], torch.full_like(g[:, None], -1)).to(torch.int32)


def point_to_voxel_map(level: SparseLevel, xyz, batch, valid,
                       voxel_size: float = 1.0) -> torch.Tensor:
    """Map points to voxel rows of ``level`` (-1 where absent)."""
    q = torch.floor(true_div(xyz, voxel_size)).to(torch.int32)
    q = torch.div(q, level.stride, rounding_mode="floor") * level.stride
    c4 = torch.cat([batch[:, None].to(torch.int32), q], 1)
    hi, lo = ck.pack(c4, valid)
    idx, found = ck.lookup(level.hi, level.lo, hi, lo)
    return torch.where(found, idx, torch.full_like(idx, -1))


@dataclass
class UNetTopology:
    """All levels and kernel maps a MinkUNet forward needs.

    levels[0] is tensor stride 1; levels[i] stride 2**i.
    """

    levels: tuple  # tuple[SparseLevel]
    stem_map: torch.Tensor  # (M0, 125) k=5 stem map
    k3_maps: tuple  # per level: (M_l, 27) stride-1 k=3 map
    down_maps: tuple  # l -> l+1: (M_{l+1}, 8) k=2 s=2 conv map
    up_maps: tuple  # l+1 -> l: (M_l, 8) k=2 s=2 transposed-conv map
    level_overflow: torch.Tensor  # () int32 voxels beyond level caps
    grid_overflow: torch.Tensor  # () int32, always 0 (no grids here)
    # banded conv plans (nn/onehot_conv.attach_plans): OnehotPlan or None,
    # aligned with k3_maps/down_maps/up_maps; the k=5 stem never bands
    k3_plans: tuple = ()
    down_plans: tuple = ()
    up_plans: tuple = ()
    # () int32 map entries outside their band (0 without plans)
    plan_overflow: torch.Tensor = field(
        default_factory=lambda: torch.zeros((), dtype=torch.int32))

    def replace(self, **kw) -> "UNetTopology":
        return dataclasses.replace(self, **kw)


# the 27 k=3 offsets as columns of the 125-offset k=5 stem map
_K3_IN_K5 = np.array([
    [tuple(o) for o in kernel_offsets(5)].index(tuple(o))
    for o in kernel_offsets(3)
])


def build_unet_topology(level0: SparseLevel, caps: Sequence[int]) -> UNetTopology:
    """Coordinate pyramid + kernel maps for a MinkUNet: ``len(caps)``
    levels, ``caps[l]`` the static voxel capacity of level ``l``.  Maps at
    equal stride are built once and shared by every residual block there.
    """
    num_levels = len(caps)
    levels = [level0]
    for l in range(1, num_levels):
        levels.append(downsample(levels[-1], 2, caps[l]))
    level_overflow = sum(
        torch.clamp(lv.count - lv.cap, min=0) for lv in levels
    ).to(torch.int32)
    stem = conv_map(levels[0], levels[0], 5)
    # the 27 k=3 offsets are a subset of the 125 stem offsets at the same
    # level: slice columns instead of looking them up again
    k3_0 = stem[:, torch.as_tensor(_K3_IN_K5, device=stem.device)]
    k3 = (k3_0,) + tuple(conv_map(lv, lv, 3) for lv in levels[1:])
    down = tuple(
        conv_map(levels[l + 1], levels[l], 2) for l in range(num_levels - 1)
    )
    up = tuple(
        up_map_direct(levels[l], levels[l + 1]) for l in range(num_levels - 1)
    )
    return UNetTopology(
        levels=tuple(levels), stem_map=stem, k3_maps=k3, down_maps=down,
        up_maps=up, level_overflow=level_overflow,
        grid_overflow=torch.zeros((), dtype=torch.int32, device=stem.device),
        plan_overflow=torch.zeros((), dtype=torch.int32, device=stem.device),
    )
