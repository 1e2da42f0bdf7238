"""Matrix NMS over proposal masks (port of pbnet_tpu/ops/nms.py).

The reference computes the (P, P) cross-IoU with one mask matmul and runs
greedy NMS on the host (PBNet eval_map.py:87-98, tools/mIOU.py:77-87).
``cross_iou`` and ``greedy_nms`` do the same on tensors of any device;
``greedy_nms_np`` is the host version the eval pipeline calls.
"""

from __future__ import annotations

import numpy as np
import torch


def cross_iou(masks: torch.Tensor) -> torch.Tensor:
    """(P, N) binary masks -> (P, P) IoU matrix (one matmul)."""
    m = masks.to(torch.float32)
    inter = m @ m.T
    size = m.sum(1)
    union = size[:, None] + size[None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def greedy_nms(ious: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               threshold: float) -> torch.Tensor:
    """Greedy NMS as tools/mIOU.py:77-87: repeatedly pick the highest-score
    remaining proposal and suppress those with IoU > threshold.  Returns a
    (P,) bool keep mask (the reference returns pick indices in score order;
    a mask is equivalent downstream)."""
    p = ious.shape[0]
    idx = torch.arange(p, device=ious.device)
    alive = valid.clone()
    keep = torch.zeros(p, dtype=torch.bool, device=ious.device)
    while bool(alive.any()):
        i = int(torch.where(alive, scores, -torch.inf).argmax())
        keep[i] = True
        alive &= ~((ious[i] > threshold) | (idx == i))
    return keep


def greedy_nms_np(ious: np.ndarray, scores: np.ndarray, threshold: float) -> np.ndarray:
    """Host oracle: literal port of the reference algorithm."""
    ixs = scores.argsort()[::-1]
    pick = []
    while len(ixs) > 0:
        i = ixs[0]
        pick.append(i)
        iou = ious[i, ixs[1:]]
        remove = np.where(iou > threshold)[0] + 1
        ixs = np.delete(ixs, remove)
        ixs = np.delete(ixs, 0)
    return np.array(pick, dtype=np.int32)
