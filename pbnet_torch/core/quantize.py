"""Voxel quantization (port of pbnet_tpu/core/quantize.py).

* :func:`sparse_quantize_np` — host numpy, for the data path.
* :func:`quantize_device` — static-shape, on tensors, for the stage-2 local
  scenes and the stage-3 proposals.

Semantics: coordinates are ``floor(xyz / voxel_size)``; duplicates within one
batch item collapse to one voxel represented by its first occurrence (lowest
input row); the inverse map sends every input row to its voxel row, or -1
for pads and rows past the voxel cap.
"""

from __future__ import annotations

import numpy as np
import torch

from . import coords as ck


def sparse_quantize_np(xyz: np.ndarray, voxel_size: float):
    """Quantize points on the host.

    Returns ``(vox_coords (M,3) int32, index (M,) int64 first-occurrence
    rows, inverse (N,) int64 point->voxel map)``.
    """
    q = np.floor(xyz / voxel_size).astype(np.int64)
    key = (q[:, 0] * ck.MAX_YZ + q[:, 1]) * ck.MAX_YZ + q[:, 2]
    _, index, inverse = np.unique(key, return_index=True, return_inverse=True)
    return q[index].astype(np.int32), index.astype(np.int64), inverse.astype(np.int64)


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as an IEEE f32 division.  CUDA divides by a host scalar as
    ``x * (1/s)``, which rounds differently; dividing by a device tensor
    keeps the division exact, so ``floor`` of the quotient matches the JAX
    package's on every device."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def quantize_device(xyz, batch, valid, voxel_cap: int, voxel_size: float = 1.0):
    """Static-shape quantization of batched points.

    Args:
      xyz: (P, 3) float32 coordinates (non-negative).
      batch: (P,) int32 batch-item (or proposal) id per point.
      valid: (P,) bool point validity mask.
      voxel_cap: static capacity M of the voxel arrays.
      voxel_size: quantization cell size.

    Returns a dict with ``coords`` (M, 4), ``hi``/``lo`` (M,) sorted keys,
    ``valid`` (M,), ``count`` (0-dim, may exceed M: the overflow
    indicator), ``point2voxel`` (P,) (-1 for pads/overflow) and
    ``voxel2point`` (M,) first input point of each voxel (pads -> 0).
    """
    dev = xyz.device
    p = xyz.shape[0]
    q = torch.floor(true_div(xyz, voxel_size)).to(torch.int32)
    c4 = torch.cat([batch[:, None].to(torch.int32), q], 1)
    hi, lo = ck.pack(c4, valid)
    row = torch.arange(p, dtype=torch.int32, device=dev)
    hi_s, lo_s, c4_s, row_s = ck.sort_by_key(hi, lo, c4, row)
    first, unique_pos, count = ck.unique_sorted(hi_s, lo_s)

    m = voxel_cap
    ok = first & (unique_pos < m)
    # overflow and duplicate rows all land in scratch slot m (discarded)
    dst = torch.where(ok, unique_pos, m).to(torch.int64)
    sent = torch.full_like(hi_s, ck.SENTINEL)
    vox_coords = torch.zeros((m + 1, 4), dtype=torch.int32, device=dev)
    vox_coords[dst] = c4_s
    vox_hi = torch.full((m + 1,), ck.SENTINEL, dtype=torch.int32, device=dev)
    vox_hi[dst] = torch.where(ok, hi_s, sent)
    vox_lo = torch.full((m + 1,), ck.SENTINEL, dtype=torch.int32, device=dev)
    vox_lo[dst] = torch.where(ok, lo_s, sent)
    # the sort is stable, so the first row of each key run is the lowest
    # original row of that voxel
    vox2pt = torch.zeros((m + 1,), dtype=torch.int32, device=dev)
    vox2pt[dst] = row_s
    vox_hi, vox_lo = vox_hi[:m], vox_lo[:m]

    p2v_sorted = torch.where(
        (unique_pos < m) & (hi_s != ck.SENTINEL), unique_pos,
        torch.full_like(unique_pos, -1),
    )
    point2voxel = torch.full((p,), -1, dtype=torch.int32, device=dev)
    point2voxel[row_s.to(torch.int64)] = p2v_sorted

    return {
        "coords": vox_coords[:m],
        "hi": vox_hi,
        "lo": vox_lo,
        "valid": vox_hi != ck.SENTINEL,
        "count": count,
        "point2voxel": point2voxel,
        "voxel2point": vox2pt[:m],
    }
