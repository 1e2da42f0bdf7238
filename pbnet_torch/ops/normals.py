"""Mesh vertex normals (port of pbnet_tpu/ops/normals.py).

Per-vertex normals as the sum of the incident face normals (each of length
twice its face's area, so area-weighted), then L2-normalized: the numpy
version the decoder uses and a tensor version (``index_add_`` over the face
corners), the counterpart of the JAX package's segment-sum.
"""

from __future__ import annotations

import numpy as np
import torch


def vertex_normals_np(xyz: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals; O(F) instead of the reference's O(V*F)."""
    v0, v1, v2 = xyz[faces[:, 0]], xyz[faces[:, 1]], xyz[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # length = 2*area -> area weighting
    vn = np.zeros_like(xyz)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def vertex_normals(xyz: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """The tensor version, on the device of ``xyz``."""
    f = faces.long()
    v0, v1, v2 = xyz[f[:, 0]], xyz[f[:, 1]], xyz[f[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    vn = torch.zeros_like(xyz)
    for k in range(3):
        vn = vn + torch.zeros_like(xyz).index_add_(0, f[:, k], fn)
    norm = torch.linalg.vector_norm(vn, dim=1, keepdim=True)
    return vn / torch.clamp(norm, min=1e-12)
